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
   bandwidth bound.  Where the parent commit's fused_adam.cu was copied to
   ``shine_mapping_tpu_torch/csrc/build/parent/`` (git-ignored), its kernel
   is built too and timed beside the new one in turns (old, new, new, old)
   on the same inputs, through its own C interface (no work list), and its
   stochastic-rounding bits compared.  Then the hot case: K1's per-level
   step in one launch on two levels of 1,024 used rows taking 32,768
   entries each, one level's all on one row (the work list splits every
   tile), against the per-level plain steps (phase 2's tolerance plus the
   sum-order spread, bit-equal on single-entry rows), its times beside the
   parent's two launches in turns;
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
   launch per step) and 50 with the per-level update (one prep and one
   launch per step over the levels, each with its lr) on iid batches; then
   pool lookups + epoch windows (W = 245): 200
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
   (bs 4096, 50 steps a frame, lambda 1e6, live probes, K1's per-level
   step (one launch a step over the levels) with the reg folded into its
   entries, the importance sweep after each frame,
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
   its plain version, and the tables after them against the CPU's at rtol
   1e-4 plus the allowance each step's sum-order spread carries through
   Adam (``_CarriedAllowance``; its largest share used is printed);
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
   points of F's;
9. multi: training on several cards.  ``[kernels]`` K2's row-sharded
   caller (``fused_adam_shard``, f32, bf16 moments, bf16 p + SR) at the
   main path's shapes over 2 and 4 shards: each shard against its plain
   version (phase 2's tolerance plus the sum-order spread), the shards'
   blocks concatenated against one unsharded K2 launch (bf16 p bit-equal on
   rows with at most one entry: the rounding noise is keyed by the whole
   table's element), wrapper / alone / plain / bound ms.  ``[multi]``: ranks
   spawned on the cards present (two on one card over gloo; one a card over
   NCCL where there are two or more) train the ICRA config on the bench
   world, 30 steps a run: (a) replicated tables, iid K2; (b) replicated,
   the bf16 map mode on fused windows; (c) row-sharded tables on routed
   fused windows, f32 (K2's row-sharded caller); (d) (c) with bf16 tables;
   (e) (c) with bf16 moments, 20 steps.  Each: ms/step, launches per rank,
   collectives' calls and bytes per step, peaks per rank, the fixed-sample
   loss falling; (a), (b): every rank's tables, moments and decoders
   bit-identical after every chunk; (c)-(e): after the first step the
   tables held against a one-rank run of the same windows from the same
   state (phase 2's tolerance plus the sum-order spread, bf16 bit-equal on
   rows with at most one entry), after the last the fixed-sample loss
   within 5 % of its drop.  ``[multi] cli``: the batch CLI with
   ``tpu.mesh_shape: 2``, row-sharded tables and the bf16 map mode on phase
   6's world, 500 steps: the bars, within 5 F-score points of run B, and on
   its rank-0 checkpoint two ranks' sharded data phase (= the one-process
   pool and octree), data-parallel meshing (= one rank's masks and sdf) and
   the checkpoint cut into row blocks and written again (bit-equal);
10. incre-multi: the incremental driver over several ranks and row-sharded
   tables on iid batches.  ``[kernels]`` K2's row-sharded caller on a live
   prep: the entries of one step as a live routing delivers them to each of
   2 shards (cells padded to the largest), binned by csrc/entry_prep.cu
   (``entry_prep_shard``: the sorted prep's tiles and (row, entry) pairs,
   pads excluded) and stepped by ``fused_adam_shard`` against its plain
   version on that prep (phase 2's checks plus the sum-order spread, bf16
   moments' one-ulp ties), with prep / wrapper / alone / plain / library /
   bound ms.  ``[incre-multi]`` (f), (g): ranks as phase 9's train the ICRA
   config on the bench world with row-sharded tables on iid batches, 50
   steps (in the full run in phase 9's spawn, on its bench world), (f)
   ``fused`` (one live prep and one K2 row-sharded launch a step), (g)
   ``sparse`` (no kernel); each held after the first step and
   the last against the one-rank run of the same draws as phase 9 holds
   (c)-(e).  (h), (i): the incremental CLI over two ranks (gloo on one
   card, NCCL one a card) on 5 frames of phase 7's world, (h) run E's
   config (replicated tables, the reg on fused windows, bf16 moments, K2),
   (i) run C's config with row-sharded tables (the reg on the rows' ranks,
   live routing, K2's row-sharded caller); launches per rank, the replicas
   (h) and the importance tables bit-identical after every frame,
   ``reg_loss`` after frame 0, the F-score within 5 points of the one-rank
   run of the same config and frames.
11. surface: the launch through the config's knobs, the visualizer and the
   RGB-D family.  The card's name and power limit.  (j) Two processes
   launched apart, each with ``tpu.num_processes: 2``, its own
   ``process_id`` and a localhost coordinator, run the batch CLI with phase
   9's ``[multi] cli`` config (row-sharded tables, the bf16 map mode) and
   ``tpu.mesh_shape: 4`` on phase 6's world, 200 steps: two local ranks
   each, 4 gloo ranks on one card (on four cards each process sees two
   through its own ``CUDA_VISIBLE_DEVICES``: NCCL, one rank a card); the
   primary prints 4 ranks, each rank launches K2's row-sharded caller once
   a step, and each rank's step 100 is held against the plain version at
   its own row blocks with phase 9's bf16-p checks (``[kernels] K2 shard
   ... at run (j)'s row blocks``; the check's launches are not counted),
   phase 6's bars and within 5 F-score points of run B, one run
   directory (rank 0's) returned by both processes, and the final
   checkpoint's fixed-sample loss within 5 % of the drop of a one-process
   ``mesh_shape: 4`` spawn of the same config.  The synthetic room
   (tests/test_torch_rgbd_converter.py: 30 frames of 640 x 480, 16-bit
   millimetre depth PNGs, RGB PNGs, NeuralRGBD's focal file and 4x4 poses,
   exact ground truth) converted by ``python -m
   shine_mapping_tpu_torch.data.rgbd_converter``.  (k) The batch CLI with
   ``config/rgbd/rgbd_batch.yaml`` at its full width (4 levels, D 8, leaf
   0.02 m, world level 12, bs 4096, 2x32 MLP, sdf_bce, octree meshing at
   0.01 m) and ``o3d_vis_on``, 2,000 steps: one K1 launch a step over the 4
   levels (and its live prep) and no other kernel, the loss falling, Chamfer-L1 < 1 cm and
   the F-score at 2 cm > 90 % against the ground truth, one non-blank
   snapshot a mesh in ``run_path/vis``.  (l) The incremental CLI with
   ``rgbd_incre_reg.yaml`` on 5 overlapping frames of the room: the reg
   after frame 0, one snapshot a frame, the F-score within 5 points of the JAX driver's
   on the CPU (``JAX_ROOM_INCRE_FSCORE``).  Cuts on ``[surface] reduced:``
   lines.  ``[kernels]`` K1 at 4 levels in one launch at run (k)'s final
   tables and at run (l)'s, each against the per-level plain steps (phase
   2's checks plus the sum-order spread) with the step's call / with-pre /
   alone / the parent's four launches alone in turns / plain / library /
   bound ms, and each a JSON row of its own with its run's launches.
   ``--only agreement,city`` (any of kernels: phase 2 without 2b,
   agreement, map, incre, city, multi, incre-multi, surface, and launch:
   phase 11's (j) alone) runs those phases alone and prints no result
   line.

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


def nvidia_smi():
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def phase_device():
    import torch

    from shine_mapping_tpu_torch.ops import cuda_build

    smi = nvidia_smi()
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
    puts it there), else None.  It keeps this commit's C interface, so
    :func:`_launch_parent` launches it through ``adam_kernel._launch``."""
    from shine_mapping_tpu_torch.ops import cuda_build

    if not os.path.exists(os.path.join(PARENT_DIR, "fused_adam.cu")):
        return None
    return cuda_build.load("fused_adam", PARENT_DIR, PARENT_DIR)


def _launch_parent(lib, variant, ps, ms, vs, gs, ent_off, pre, n_used, offs, lrs, b1, b2,
                   bc1, bc2, eps, grads_bf16=False, seed=0, row_base=None, det=False):
    """One launch of the parent commit's fused_adam.cu (``lib``:
    :func:`_parent_lib`) on ``pre`` (its work list included); not counted."""
    from shine_mapping_tpu_torch.ops import adam_kernel as ak

    ak._launch(variant, ps, ms, vs, gs, ent_off, pre, n_used, offs, lrs, b1, b2, bc1, bc2, eps,
               grads_bf16, seed, lib=lib, row_base=row_base, det=det)


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
                _launch_parent(parent, variant, *ts, gl, ent_off[:levels], pre, nu,
                               offs[:levels], lrs, 0.9, 0.99, bc1, bc2, 1e-15,
                               kw["grads_bf16"], seed)

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
    # the hot case: two levels of 1,024 used rows, 32,768 entries each, the
    # second's all on one row (the work list splits every tile)
    rows_json.append(phase_surface_kernel("phase 2's hot case", [1 << 16] * 2, [1024] * 2,
                                          32768, one_row=1))
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
    ("per-level (K1)", "fused_adam", 1, 50, False, None, False, False),
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
        # every step steps every level: K1 in one launch over all of them on
        # iid batches (fused_adam_levels) or one a level on per-level
        # windows, K2 in one
        L = len(grid.levels)
        assert ak.LEVEL_STEPS[key] == steps * L, \
            f"{key}: {ak.LEVEL_STEPS[key]} level steps, want {steps * L}"
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
    """While active, every K1 (``fused_adam``, ``fused_adam_levels``) and K2
    (``fused_adam_multi``) launch on CUDA tensors is held against its plain
    version on the same
    inputs: phase 2's tolerance plus each element's sum-order spread
    (:func:`_sum_order_spread`, the card's atomics sum a row's entries in no
    fixed order), bit-equal on rows with at most one entry, headroom
    untouched; bf16 moments bit-equal but for TIE_SHARE one-ulp ties."""

    def __init__(self):
        from shine_mapping_tpu_torch.ops import adam_kernel as ak

        self.ak, self.n, self.err = ak, 0, 0.0
        self.inner = (ak.fused_adam, ak.fused_adam_multi, ak.fused_adam_levels)

    def __enter__(self):
        ak, (k1, k2, k1l) = self.ak, self.inner

        def one(p, m, v, rows, grads, lr, bc1, bc2, n_used=None, **kw):
            return self._check([p], [m], [v], [rows], [grads], lr, bc1, bc2, [1.0],
                               [p.shape[0] if n_used is None else n_used], kw,
                               lambda: k1(p, m, v, rows, grads, lr, bc1, bc2, n_used, **kw))

        def multi(ps, ms, vs, rows_l, g_l, lr, bc1, bc2, lr_scales, n_used=None, **kw):
            nu = [p.shape[0] for p in ps] if n_used is None else list(n_used)
            return self._check(ps, ms, vs, rows_l, g_l, lr, bc1, bc2, lr_scales, nu, kw,
                               lambda: k2(ps, ms, vs, rows_l, g_l, lr, bc1, bc2, lr_scales,
                                          n_used, **kw))

        def levels(ps, ms, vs, rows_l, g_l, lr, bc1, bc2, lr_scales, n_used=None, **kw):
            nu = [p.shape[0] for p in ps] if n_used is None else list(n_used)
            return self._check(ps, ms, vs, rows_l, g_l, lr, bc1, bc2, lr_scales, nu, kw,
                               lambda: k1l(ps, ms, vs, rows_l, g_l, lr, bc1, bc2, lr_scales,
                                           n_used, **kw))

        ak.fused_adam, ak.fused_adam_multi, ak.fused_adam_levels = one, multi, levels
        return self

    def __exit__(self, *exc):
        self.ak.fused_adam, self.ak.fused_adam_multi, self.ak.fused_adam_levels = self.inner

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
            # one launch a step: K2 on fused windows, K1's per-level step in one
            assert kc.n == n_steps, f"{label}: {kc.n} launches checked"
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
MAP_B = "run B (bf16 map mode, K2 + SR)"
# each _map_run's F-score by label (phase 9 holds its two-rank run to run B's)
MAP_SCORES = {}
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
    assert ak.LEVEL_STEPS[launch_key] == cfg.iters * cfg.tree_level_feat, \
        f"{label}: {ak.LEVEL_STEPS[launch_key]} level steps"  # every level, every step
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
    MAP_SCORES[label] = m["F-score (%)"]
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
        # per level: one live entry prep and one launch a step over the 3
        # levels) and dense-bbx meshing
        cfg = _map_config(os.path.join(tmp, "world"), os.path.join(tmp, "a"), iters_a)
        run_path, grid, params, counts = _map_run(
            "run A (ICRA config, K1)", cfg, gt_path, "fused_adam", 1, iters_a)
        launches.update(counts)
        _map_checkpoint_roundtrip(cfg, run_path, grid, params, gt_path)
        _map_agreement(cfg, grid, params)
        del grid, params
        # run B: the bf16 map mode through the CLI (pool lookups, fused
        # epoch windows, bf16 moments and tables, K2 with stochastic rounding)
        cfg = _map_config(os.path.join(tmp, "world"), os.path.join(tmp, "b"), iters_b,
                          feature_update="pallas", moments_bf16=True, batch_windows=True,
                          params_bf16=True)
        _, grid, params, counts = _map_run(MAP_B, cfg, gt_path, "fused_adam_multi_bf16p", 1, 1)
        assert grid.features[0].dtype.itemsize == 2, "run B did not keep bf16 tables"
        for k, n in counts.items():
            launches[k] = launches.get(k, 0) + n
    return launches


# ----------------------------------------------------------------- phase 7


# (label, config, tpu knobs, the work-ratio gate forced open, the update's
# launch key, its launches per step)
INCRE_RUNS = (
    ("C", "config/maicity/maicity_incre_reg.yaml", {}, False, "fused_adam", 1),
    ("D", "config/maicity/maicity_incre_replay.yaml", {}, False, "fused_adam", 1),
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
    assert ak.LEVEL_STEPS[key] == steps * cfg.tree_level_feat, \
        f"run {label}: {ak.LEVEL_STEPS[key]} level steps"  # every level, every step
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


# the card's own gradient entries may differ from the CPU's by this many
# ulps of each entry before the sum (see _CarriedAllowance)
ENTRY_ULPS = 32


class _CarriedAllowance:
    """How far a run's tables may drift, step by step, from another run of
    the same steps on other hardware, per element: the sum-order spread of
    each step carried through Adam's recurrences.

    A step sums each row's k entries g_i.  Two runs part there by at most

        s = (2 gamma_{k-1} + c u) sum |g_i|
            + 2 lambda ((imp + |d imp|) A_p + |d imp| |p - last|)   (reg rows)

    u = 2^-24, gamma_j = j u / (1 - j u).  The first term is the sum order:
    any order of k terms lies within gamma_{k-1} sum |g_i| of the exact
    sum, so two orders within twice that (``_sum_order_spread``'s shift).
    The second covers the card's own entries, which reach the sum a few
    ulps away from the CPU's: an entry is a trilinear weight (three
    differences and two products, ~5 roundings) times the decoder's
    backward into a feature lane, a 32-term sum over the hidden units
    (cuBLAS and the CPU sum it in other orders: gamma_31 of its terms'
    magnitudes), so c = ENTRY_ULPS = 32 ulps of each entry.  The third is
    the continual reg folded into a row's owner entry, 2 lambda imp (p -
    last): it moves by 2 lambda imp times the drift A_p of p carried from
    the steps before, and by the importance's own card-vs-CPU difference
    (``d imp``, measured by the sweep's check) times |p - last|; at lambda
    1e6 both are many ulps of the entry.

    Through Adam (m' = b1 m + (1 - b1) g, v' = b2 v + (1 - b2) g^2, p' = p -
    lr (m' / bc1) / (sqrt(v' / bc2) + eps)), to first order:

        A_m,t = b1 A_m,t-1 + (1 - b1) s_t
        A_v,t = b2 A_v,t-1 + (1 - b2) (2 |g_t| s_t + s_t^2)
        A_p,t = A_p,t-1 + max over the four corners (m' +- A_m,t, v' +- A_v,t)
                of |step(corner) - step(m', v')|

    (the step is monotone in m' and in v', so the corners bound it; this
    also holds each step's own p spread).  m', v', g_t are the plain
    version's on the card's inputs, in float64.  An end state within rtol,
    atol and A of the other run's is what both runs can reach; the check
    adds A to the tolerance it had and widens nothing else."""

    u = 2.0 ** -24

    def __init__(self, b1=0.9, b2=0.99, entry_ulps=ENTRY_ULPS):
        self.b1, self.b2, self.c = b1, b2, entry_ulps
        self.A = {}  # level -> [A_p, A_m, A_v], (C, D) float64
        self.entry_terms = []  # per step and level: s less its sum-order term

    def step(self, level, t0, plain, rows, grads, lr, bc1, bc2, n_used, eps, reg=None):
        """Carry level ``level``'s allowance through one step: ``t0`` the
        step's input tables [p, m, v], ``plain`` the plain version's outputs
        on them, ``rows``, ``grads`` its entries; ``reg``: (lambda, imp, d
        imp, last frame) of the continual reg, or None."""
        import torch

        C, D = t0[0].shape
        dev = t0[0].device
        r, g = rows.reshape(-1).long(), grads.reshape(-1, D).double()
        keep = (r >= 0) & (r < n_used) & (r != C - 1)
        r, g = r[keep], g[keep]
        k = torch.bincount(r, minlength=C).double()[:, None]
        abs_sum = torch.zeros((C, D), dtype=torch.float64, device=dev).index_add_(0, r, g.abs())
        g_sum = torch.zeros((C, D), dtype=torch.float64, device=dev).index_add_(0, r, g)
        km1 = (k - 1).clamp(min=0)
        gamma = km1 * self.u / (1 - km1 * self.u)
        entry = self.c * self.u * abs_sum
        A_p, A_m, A_v = self.A.get(level, [torch.zeros((C, D), dtype=torch.float64,
                                                       device=dev) for _ in range(3)])
        if reg is not None:
            lam, imp, dimp, last = (x if isinstance(x, float) else x.double() for x in reg)
            feed = 2 * lam * ((imp + dimp) * A_p + dimp * (t0[0].double() - last).abs())
            entry = entry + torch.where(k > 0, feed, 0.0)
        self.entry_terms.append(entry.cpu())
        shift = 2 * gamma * abs_sum + entry
        A_m = self.b1 * A_m + (1 - self.b1) * shift
        A_v = self.b2 * A_v + (1 - self.b2) * (2 * g_sum.abs() * shift + shift * shift)
        m, v = plain[1].double(), plain[2].double()

        def upd(m_, v_):
            return lr * (m_ / bc1) / (torch.sqrt(v_.clamp(min=0) / bc2) + eps)

        base = upd(m, v)
        dp = torch.zeros_like(base)
        for sm in (-1, 1):
            for sv in (-1, 1):
                dp = torch.maximum(dp, (upd(m + sm * A_m, v + sv * A_v) - base).abs())
        head = torch.arange(C, device=dev)[:, None] < n_used  # rows past it never move
        A_p = A_p + torch.where(head, dp, 0.0)
        self.A[level] = [A_p, torch.where(head, A_m, 0.0), torch.where(head, A_v, 0.0)]


def _end_state_check(name, a, b, atol, allow, rtol=1e-4):
    """``a`` against ``b`` (same device) within atol + rtol |b| plus the
    carried ``allow`` (float64).  Returns (the largest share of it used,
    the elements past atol + rtol |b| alone); raises AssertionError on any
    element past it all."""
    d = (a.double() - b.double()).abs()
    tol = atol + rtol * b.double().abs()
    full = tol + allow
    bad = ~(d <= full)
    worst = int((d / full).reshape(-1).argmax())
    assert not bad.any(), (
        f"{name}: {int(bad.sum())} of {d.numel()} elements past rtol {rtol:g}, atol {atol:.3g} "
        f"and the carried allowance; worst |d| {float(d.reshape(-1)[worst]):.4g}, at most "
        f"{float(full.reshape(-1)[worst]):.4g} allowed there (carried "
        f"{float(allow.reshape(-1)[worst]):.4g})")
    return float((d / full).max()), int((d > tol).sum())


def _incre_agreement(cfg, grid, params, n_frames, steps=5):
    """Card = CPU on run C's final state and its last frame's pool: the
    importance sweep (rtol 1e-5, atol 1e-6 of each table's largest value,
    on all but 1e-4 of the elements, and within 1e-4 of the largest value
    on all: a row's per-batch gradient sum that nearly cancels keeps its
    terms' rounding, which cuBLAS and the card's atomics leave in another
    order than the CPU's; measured 1-6 of 524,288 elements off, by up to
    1.8e-3 of their value and 1.2e-5 of the largest), then 5 reg steps at
    adam_eps 1e-3 (so the step is a smooth function of the gradient, as in
    phase 5) on the same batches.  On the card every K1 launch of those
    steps (one a step over the 3 levels) is held against its plain version
    on the same inputs, level by level, at phase 2's tolerance plus each
    element's sum-order spread (:func:`_sum_order_spread`: at lambda 1e6 a
    row's reg and loss gradients nearly cancel, and the card's atomics sum
    them in no fixed order; no share of the head needs to move: a fresh
    Adam state leaves untouched rows in place).  After the 5 steps: the
    decoders rtol 1e-4, atol 1e-5; the tables p at rtol 1e-4, atol 1e-5, m
    and v at rtol 1e-4 with an atol of 1e-6 of the table's largest value
    (at least 1e-5: the reg gradients reach 2 lambda imp |p - last|), each
    plus the allowance that each step's spread leaves after the steps
    (:class:`_CarriedAllowance`, built from the card's launches: the
    card's steps keep the atomics the real run uses)."""
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
    kernel_err, inner = [0.0, 0, 0, 0.0], ak.fused_adam_levels
    carried = _CarriedAllowance()
    g_card = sides["card"][0]
    reg = [(float(cfg.lambda_forget), imp,
            (imp - b.to(imp.device)).abs(), last)
           for imp, b, last in zip(g_card.importance_weight, sides["cpu"][0].importance_weight,
                                   g_card.features_last_frame)]

    def checked(ps, ms, vs, rows_l, g_l, lr, bc1, bc2, lr_scales, n_used=None, **kw):
        t0s = [[x.clone() for x in lv] for lv in (ps, ms, vs)]
        out = inner(ps, ms, vs, rows_l, g_l, lr, bc1, bc2, lr_scales, n_used, **kw)
        step = {k: kw[k] for k in ("eps", "grads_bf16") if k in kw}
        for l, (p, m, v, rows, grads) in enumerate(zip(ps, ms, vs, rows_l, g_l)):
            lr_l, nu = lr * lr_scales[l], n_used[l]
            t0 = [x[l] for x in t0s]
            plain = [x.clone() for x in t0]
            ak.fused_adam_plain(*plain, rows, grads, lr_l, bc1, bc2, nu, **step)
            single = _single_rows([rows], [p.shape[0]], [nu])
            spread = _sum_order_spread(t0, rows, grads, lr_l, bc1, bc2, nu, **step)
            _check_f32([[p], [m], [v]], [[x] for x in plain], [[x] for x in t0], [nu],
                       single=single, moved_share=None, scale_of="after", spread=spread)
            for a, b, (sp,) in zip((p, m, v), plain, spread):  # v reaches ~1e13 here
                rel = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
                kernel_err[0] = max(kernel_err[0], rel)
                allow = min(1e-6, 1e-5 * float(b[:nu].abs().max())) + 1e-5 * b.abs()
                kernel_err[2] += int(((a - b).abs() > allow).sum())  # needed their spread
                kernel_err[3] = max(kernel_err[3], _share_used(a, b, allow + sp))
            carried.step(l, t0, plain, rows, grads, lr_l, bc1, bc2, nu, step["eps"], reg[l])
        kernel_err[1] += 1
        entries["card"].append([(r.cpu(), x.cpu()) for r, x in zip(rows_l, g_l)])
        return out

    entries = {"card": [], "cpu": []}

    def recorded(ps, ms, vs, rows_l, g_l, *a, **kw):
        entries["cpu"].append([(r.clone(), x.clone()) for r, x in zip(rows_l, g_l)])
        return inner(ps, ms, vs, rows_l, g_l, *a, **kw)

    out = {}
    for side, (g, p, pool, n) in sides.items():
        shadow = {"importance": g.importance_weight, "last_frame": g.features_last_frame}
        ak.fused_adam_levels = checked if side == "card" else recorded
        try:
            p, opt, aux = trainer.train_chunk(p, init_opt_state(p), g.tables, pool, n, 0, None,
                                              s, steps, batch_indices=idx, shadow=shadow)
        finally:
            ak.fused_adam_levels = inner
        out[side] = (p, opt, float(aux["mean"]["reg_loss"]), float(aux["mean"]["total_loss"]))
    (pc, oc, rc, lc), (pp, op, rp, lp) = out["card"], out["cpu"]
    np.testing.assert_allclose(rc, rp, rtol=1e-5)
    np.testing.assert_allclose(lc, lp, rtol=1e-5)
    used = {"p": 0.0, "m": 0.0, "v": 0.0, "decoder": 0.0}
    past = {"p": 0, "m": 0, "v": 0}
    for l, (a, b) in enumerate(zip(pc["features"], pp["features"])):
        share, n_past = _end_state_check(f"p[{l}]", a.cpu(), b, 1e-5, carried.A[l][0].cpu())
        used["p"], past["p"] = max(used["p"], share), past["p"] + n_past
    for k, name in ((1, "m"), (2, "v")):
        for l, (a, b) in enumerate(zip(getattr(oc, name)["features"],
                                       getattr(op, name)["features"])):
            atol = max(1e-5, 1e-6 * float(b.abs().max()))
            share, n_past = _end_state_check(f"{name}[{l}]", a.cpu(), b, atol,
                                             carried.A[l][k].cpu())
            used[name], past[name] = max(used[name], share), past[name] + n_past
    for k, b in pp["geo"].state_dict().items():
        a = pc["geo"].state_dict()[k].cpu()
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
        used["decoder"] = max(used["decoder"], _share_used(a, b, 1e-5 + 1e-4 * b.abs()))
    assert kernel_err[1] == steps, kernel_err
    # what the card's entries did differ from the CPU's: per row and lane,
    # the sum of the entries' differences, in ulps of the sum of their
    # magnitudes and as a share of the allowance's entry term (ENTRY_ULPS
    # ulps plus the reg's terms); a share above 1 is a row the term misses
    ulps, shares = [], []
    terms = iter(carried.entry_terms)
    for sc, sp in zip(entries["card"], entries["cpu"]):
        for l, ((rc_, gc), (rp_, gp)) in enumerate(zip(sc, sp)):
            assert torch.equal(rc_, rp_), "the card's batches hit other rows"
            term = next(terms)
            C, r = term.shape[0], rp_.reshape(-1).long()
            keep = (r >= 0) & (r < C - 1)
            dsum = torch.zeros(term.shape, dtype=torch.float64).index_add_(
                0, r[keep], (gc.double() - gp.double()).reshape(r.shape[0], -1)[keep].abs())
            asum = torch.zeros_like(dsum).index_add_(
                0, r[keep], gp.double().reshape(r.shape[0], -1)[keep].abs())
            hit = asum > 0
            ulps.append((dsum / (_CarriedAllowance.u * asum).clamp(min=1e-300))[hit])
            shares.append((dsum / term.clamp(min=1e-300))[hit])
    ulps, shares = torch.cat(ulps), torch.cat(shares)

    def q(x):
        return float(torch.sort(x).values[int(0.9999 * (x.numel() - 1))])

    print(f"[agreement] incremental reg: the card's entries vs the CPU's, per row and lane, "
          f"sum |d g| in ulps of sum |g|: median {float(ulps.median()):.2f}, 99.99th "
          f"percentile {q(ulps):.2f}, largest {float(ulps.max()):.2f}; as a share of the "
          f"allowance's entry term ({ENTRY_ULPS} ulps and the reg's): 99.99th percentile "
          f"{q(shares):.3f}, largest {float(shares.max()):.3f}")
    print(f"[agreement] incremental reg (run C's final state, its last frame's "
          f"{len(ds.pool)} samples): importance card vs CPU max |d| {imp_err:.3e}, "
          f"{imp_share:.6f} of the elements within rtol 1e-5 (card "
          f"{t['card']:.3f} s, CPU {t['cpu']:.3f} s); {steps} reg steps (lambda "
          f"{cfg.lambda_forget:g}) reg_loss {rc:.6g} vs {rp:.6g}, parameters and moments "
          f"agree at rtol 1e-4 plus the carried sum-order allowance (entries {ENTRY_ULPS} "
          f"ulps; largest share used: "
          + ", ".join(f"{k} {x:.3f}" for k, x in used.items())
          + "; elements past rtol 1e-4 alone: "
          + ", ".join(f"{k} {x}" for k, x in past.items())
          + f"); the {kernel_err[1]} K1 launches ({len(pc['features'])} levels each) vs "
          f"their plain versions: max |d| {kernel_err[0]:.3e} of each table's largest value, "
          f"at phase 2's tolerance plus the sum-order spread ({kernel_err[2]} elements past "
          f"phase 2's tolerance alone; largest share of the allowance used "
          f"{kernel_err[3]:.3f})")


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


# ----------------------------------------------------------------- phase 9

SHARD_TPU = "shine_mapping_tpu/ops/adam_kernel.py:528"
_SHARD_CHECKS = {"f32": "f32 tolerance plus the sum-order spread",
                 "bf16m": "p within tolerance plus the sum-order spread, moments one-ulp ties",
                 "bf16p": "p rounding against the unrounded step, moments one-ulp ties"}


def _shard_entries(rows_l, g_l, sizes, k, n, pad_share=0.1, rng=None):
    """Shard k's entries of a step, as the routed windows deliver them: the
    found entries whose rows lie in its blocks, in another order, their rows
    in its blocks concatenated, and a share of pad slots (row -1, gradient
    never read).  Returns (rows_loc int32, g_loc, per level (local rows,
    grads) of the real entries)."""
    import torch

    rl, gl, per = [], [], []
    off = 0
    for rows, g, C in zip(rows_l, g_l, sizes):
        b = C // n
        r = rows.long()
        sel = (r // b == k) & (r != C - 1)
        per.append((r[sel] - k * b, g[sel]))
        rl.append(r[sel] - k * b + off)
        gl.append(g[sel])
        off += b
    r, g = torch.cat(rl), torch.cat(gl)
    n_pad = int(pad_share * r.shape[0])
    perm = torch.from_numpy(rng.permutation(r.shape[0] + n_pad)).to(r.device)
    r = torch.cat([r, torch.full((n_pad,), -1, dtype=r.dtype, device=r.device)])[perm]
    g = torch.cat([g, torch.full((n_pad, g.shape[1]), float("nan"), device=g.device)])[perm]
    return r.to(torch.int32).contiguous(), g.contiguous(), per


def _det_check(tabs0, rows_l, g_l, sizes, n_used, scales, lr, bc1, bc2):
    """The replicas' deterministic sum (``det`` in csrc/fused_adam.cu: the
    update of runs (a) and (b)) at the main path's shapes.  Per K2 variant,
    a launch of ``fused_adam_multi(deterministic=True)`` on the sorted plain
    prep held against the plain version on the same inputs as phase 2 holds
    the atomics: f32 tables within phase 2's tolerance plus the sum-order
    spread (the plain version on the card sums by ``index_add_``'s atomics)
    and bit-equal on rows with at most one entry, bf16 moments bit-equal but
    for one-ulp ties, bf16 p against the unrounded step (:func:`_check_sr`)
    and bit-equal to the plain version with the kernel's noise on
    single-entry rows; a second launch bit-identical.  Then what the sum
    costs K2 f32: the kernel alone with ``det`` on the sorted prep against
    the atomics on csrc/entry_prep.cu's prep, and the two preps.  Returns
    the largest error against the plain version per variant."""
    import torch

    from shine_mapping_tpu_torch.ops import adam_kernel as ak

    D = tabs0[0][0].shape[1]
    tb = ak.tile_rows(D)
    plain_pre = ak.window_prep(ak.entry_prep_stack_plain([r.reshape(1, -1) for r in rows_l],
                                                         sizes, n_used, tb), 0)
    single = _single_rows(rows_l, sizes, n_used)
    lrs = [lr * x for x in scales]
    dtypes = {"f32": (torch.float32, torch.float32),
              "bf16m": (torch.float32, torch.bfloat16),
              "bf16p": (torch.bfloat16, torch.bfloat16)}
    errs = {}
    for variant, (pd, md) in dtypes.items():
        t0 = [[t.to(dt) for t in tabs0[k]] for k, dt in ((0, pd), (1, md), (2, md))]
        kw = dict(grads_bf16=variant != "f32")

        def det(seed=7):
            t = [[x.clone() for x in lv] for lv in t0]
            ak.fused_adam_multi(*t, rows_l, g_l, lr, bc1, bc2, scales, n_used, pre=plain_pre,
                                deterministic=True, sr_seed=seed if variant == "bf16p" else None,
                                **kw)
            return t

        kern, again = det(), det()
        ref = [[x.clone() for x in lv] for lv in t0]
        ak.fused_adam_multi_plain(*ref, rows_l, g_l, lr, bc1, bc2, scales, n_used,
                                  sr_seed=7 if variant == "bf16p" else None, **kw)
        torch.cuda.synchronize()
        for x, y in zip(kern, again):
            for a, b in zip(x, y):
                assert torch.equal(a.view(torch.int16 if a.itemsize == 2 else torch.int32),
                                   b.view(torch.int16 if b.itemsize == 2 else torch.int32)), \
                    f"{variant}: two det launches parted"
        if variant == "bf16p":
            exact = [[t.float() for t in t0[0]], [t.clone() for t in t0[1]],
                     [t.clone() for t in t0[2]]]
            ak.fused_adam_multi_plain(*exact, rows_l, g_l, lr, bc1, bc2, scales, n_used,
                                      grads_bf16=True)
            other = det(8)
            torch.cuda.synchronize()
            err = _check_sr(kern[0], exact[0], t0[0], n_used, again[0], other[0])[0]
            _check_bf16_ties(kern[1:], exact[1:], t0[1:], n_used)
            for t in range(3):
                for a, b, s_ in zip(kern[t], ref[t], single):
                    diff = int((a[s_].view(torch.int16) != b[s_].view(torch.int16)).sum())
                    assert diff == 0, f"det bf16p: {diff} elements of single-entry rows differ"
            del exact, other
        else:
            spread = [[], [], []]
            for l in range(len(sizes)):
                sp = _sum_order_spread([t0[0][l], t0[1][l].float(), t0[2][l].float()],
                                       rows_l[l], g_l[l], lrs[l], bc1, bc2, n_used[l], **kw)
                for t in range(3):
                    spread[t].append(sp[t][0])
            if variant == "f32":
                err = _check_f32(kern, ref, t0, n_used, single=single, spread=spread)
            else:
                err = _check_f32(kern[:1], ref[:1], t0[:1], n_used, names="p", single=single,
                                 spread=spread[:1])
                err = max(err, _check_bf16_ties(kern[1:], ref[1:], t0[1:], n_used)[0])
            del spread
        errs[variant] = err
        del t0, kern, again, ref
        torch.cuda.empty_cache()
    print(f"[kernels] K2 deterministic sum (the replicated ranks' update; 3 levels, M "
          f"{3 * rows_l[0].numel()}) vs plain at phase 2's checks (f32 tolerance plus the "
          "sum-order spread, single-entry rows bit-equal, bf16 moment ties, bf16 p rounding "
          "against the unrounded step), two launches bit-identical: max_abs_err "
          + ", ".join(f"{v} {e:.3e}" for v, e in errs.items()))

    kern_pre = ak.entry_prep(rows_l, sizes, n_used, D)
    offs = [0, sizes[0], sizes[0] + sizes[1]]
    M = rows_l[0].numel()
    t = [[x.clone() for x in lv] for lv in tabs0]

    def launch(pre, det):
        return lambda: ak._launch("f32", *t, g_l, [0, M, 2 * M], pre, n_used, offs, lrs, 0.9,
                                  0.99, bc1, bc2, 1e-15, det=det)

    t_atom, t_det = graph_ms(launch(kern_pre, False)), graph_ms(launch(plain_pre, True))
    t_prep = cuda_ms(lambda: ak.entry_prep(rows_l, sizes, n_used, D))
    t_sort = cuda_ms(lambda: ak.entry_prep_stack_plain([r.reshape(1, -1) for r in rows_l],
                                                       sizes, n_used, tb), iters=5)
    print(f"[kernels] K2 f32 deterministic sum cost: kernel alone {t_det:.4f} ms against "
          f"{t_atom:.4f} ms with atomics; its prep (stable sort) {t_sort:.4f} ms against "
          f"csrc/entry_prep.cu's {t_prep:.4f} ms; per iid step "
          f"+{t_det - t_atom + t_sort - t_prep:.4f} ms (windows: the sort is precomputed)")
    del t, kern_pre, plain_pre
    torch.cuda.empty_cache()
    return errs


def _levels_with(tabs, used):
    """A shard's tables and used rows on the levels that hold used rows
    (a level whose used head lies in other shards has none)."""
    keep = [l for l, u in enumerate(used) if u > 0]
    return [[t[l] for l in keep] for t in tabs], [used[l] for l in keep]


def phase_shard_kernels(C=1 << 22, corners=(3_180_000, 3_070_000, 2_400_000), M=65536,
                        shard_counts=(2, 4)):
    """[kernels] K2's row-sharded caller (``fused_adam_shard``) at the main
    path's shapes: the bench world's 3 x 4,194,304-row tables (used heads as
    phase 2's, zero moments past them), one step's entries (M per level,
    with duplicates; misses are not routed), split over 2 and 4 shards with
    pad slots.  Each shard's launch against its plain version with phase
    2's checks on every row (f32: its tolerance plus the sum-order spread;
    bf16 moments: one-ulp ties; bf16 p: the rounding against the unrounded
    step, the same seed the same bits) and bit-equal on rows with at most
    one entry; the shards' blocks concatenated against one unsharded K2
    launch on the same entries (rows with at most one entry bit-equal, bf16
    p too: the noise is keyed by the element's place in the whole table;
    f32 within the tolerance plus the sum-order spread, bf16 elements
    one-ulp ties); times of the fullest shard (its rows hold the most used
    rows).  Before them the replicas' deterministic sum (:func:`_det_check`)."""
    import numpy as np
    import torch

    from shine_mapping_tpu_torch.ops import adam_kernel as ak

    dev = torch.device(DEVICE)
    D = 8
    sizes = [C] * 3
    n_used = list(ak.used_rows_hint(corners, sizes))
    lr, bc1, bc2 = 0.01, 1 - 0.9 ** 5, 1 - 0.99 ** 5
    scales = [1.0, 0.5, 0.25]
    lrs = [lr * s for s in scales]
    rng = np.random.default_rng(1)
    tabs0, rows_l, g_l = _kernel_inputs(rng, sizes, n_used, M, D, dev)
    dtypes = {"f32": (torch.float32, torch.float32),
              "bf16m": (torch.float32, torch.bfloat16),
              "bf16p": (torch.bfloat16, torch.bfloat16)}
    _det_check(tabs0, rows_l, g_l, sizes, n_used, scales, lr, bc1, bc2)
    rows_json = []
    for variant in ("f32", "bf16m", "bf16p"):
        pd, md = dtypes[variant]
        kw = dict(grads_bf16=variant != "f32", sr_seed=7 if variant == "bf16p" else None)
        t0 = [[t.to(dt) for t in tabs0[k]] for k, dt in ((0, pd), (1, md), (2, md))]
        whole = [[t.clone() for t in lv] for lv in t0]
        ak.fused_adam_multi(*whole, rows_l, g_l, lr, bc1, bc2, scales, n_used, **kw)
        single = _single_rows(rows_l, sizes, n_used)
        spread_w = [[], [], []]  # the whole tables' sum-order spread (f32 p, m, v)
        if variant != "bf16p":
            for l in range(3):
                sp = _sum_order_spread([t0[0][l], t0[1][l].float(), t0[2][l].float()],
                                       rows_l[l], g_l[l], lrs[l], bc1, bc2, n_used[l],
                                       grads_bf16=kw["grads_bf16"])
                for t in range(3):
                    spread_w[t].append(sp[t][0])
        entry = {}
        for n in shard_counts:
            b = C // n
            blocks, times, errs = [], [], []
            for k in range(n):
                rows_loc, g_loc, per = _shard_entries(rows_l, g_l, sizes, k, n, rng=rng)
                loc0 = [[t[k * b:(k + 1) * b].clone() for t in lv] for lv in t0]
                base = ak.shard_row_base([(C, D)] * 3, n, k)
                pre = ak.entry_prep_local(rows_loc, [b] * 3, D)
                kern = [[t.clone() for t in lv] for lv in loc0]
                ak.fused_adam_shard(*kern, rows_loc, g_loc, lr, bc1, bc2, scales, base, pre=pre,
                                    **kw)
                ref = [[t.clone() for t in lv] for lv in loc0]
                ak.fused_adam_shard_plain(*ref, rows_loc, g_loc, lr, bc1, bc2, scales, base,
                                          pre=pre, **kw)
                torch.cuda.synchronize()
                single_k = [s_[k * b:(k + 1) * b] for s_ in single]
                used = [max(0, min(nu - k * b, b)) for nu in n_used]
                # levels whose used head lies in other shards: zero rows, a no-op
                for l in (l for l, u in enumerate(used) if u == 0):
                    for t in range(3):
                        assert torch.equal(kern[t][l].float(), loc0[t][l].float()), \
                            f"shard {k}/{n} {variant}: unused level {l} changed"
                if variant == "bf16p":
                    for t in range(3):
                        for a, c, s_ in zip(kern[t], ref[t], single_k):
                            diff = int((a[s_].view(torch.int16) != c[s_].view(torch.int16)).sum())
                            assert diff == 0, f"shard {k}/{n} bf16p: {diff} single-row elements"
                    # every row as phase 2: p's rounding against the unrounded
                    # step (same seed the same bits, another seed not), moments
                    # bit-equal but for one-ulp ties
                    exact = [[t.float() for t in loc0[0]], [t.clone() for t in loc0[1]],
                             [t.clone() for t in loc0[2]]]
                    ak.fused_adam_shard_plain(*exact, rows_loc, g_loc, lr, bc1, bc2, scales,
                                              base, pre=pre, grads_bf16=True)
                    again = [[t.clone() for t in lv] for lv in loc0]
                    other = [[t.clone() for t in lv] for lv in loc0]
                    ak.fused_adam_shard(*again, None, g_loc, lr, bc1, bc2, scales, base,
                                        pre=pre, **kw)
                    ak.fused_adam_shard(*other, None, g_loc, lr, bc1, bc2, scales, base,
                                        pre=pre, **dict(kw, sr_seed=8))
                    torch.cuda.synchronize()
                    (p_k, p_e, p_0, p_a, p_o), u_k = _levels_with(
                        [kern[0], exact[0], loc0[0], again[0], other[0]], used)
                    errs.append(_check_sr(p_k, p_e, p_0, u_k, p_a, p_o)[0])
                    mv, u_k = _levels_with(kern[1:] + exact[1:] + loc0[1:], used)
                    _check_bf16_ties(mv[0:2], mv[2:4], mv[4:6], u_k, moved_share=None)
                    del exact, again, other
                else:
                    spread = [[], [], []]
                    for l, (r_l, gg) in enumerate(per):
                        sp = _sum_order_spread([x[l] for x in loc0], r_l, gg, lrs[l], bc1, bc2,
                                               b, grads_bf16=kw["grads_bf16"])
                        for t in range(3):
                            spread[t].append(sp[t][0])
                    names = "pmv" if variant == "f32" else "p"
                    cut = 3 if variant == "f32" else 1
                    errs.append(_check_f32(kern[:cut], ref[:cut], loc0[:cut], [b] * 3,
                                           names=names, single=single_k, moved_share=None,
                                           spread=spread[:cut]))
                    if variant == "bf16m":
                        for t in (1, 2):
                            for a, c, s_ in zip(kern[t], ref[t], single_k):
                                assert torch.equal(a[s_].view(torch.int16),
                                                   c[s_].view(torch.int16)), \
                                    f"shard {k}/{n} bf16m moments differ on single rows"
                        # every row: bit-equal but for one-ulp ties, as phase 2
                        mv, u_k = _levels_with(kern[1:] + ref[1:] + loc0[1:], used)
                        errs[-1] = max(errs[-1], _check_bf16_ties(
                            mv[0:2], mv[2:4], mv[4:6], u_k, moved_share=None)[0])
                blocks.append(kern)
                # timed on copies: the checked blocks stay one step from loc0
                tim = [[t.clone() for t in lv] for lv in loc0]
                t_wrap = cuda_ms(lambda: ak.fused_adam_shard(*tim, None, g_loc, lr, bc1, bc2,
                                                             scales, base, pre=pre, **kw))

                def alone(lib=None):
                    args = (variant, *tim, [g_loc] * 3, [0] * 3, pre, [b] * 3, [0, b, 2 * b],
                            lrs, 0.9, 0.99, bc1, bc2, 1e-15, kw["grads_bf16"], 7)
                    if lib is None:
                        ak._launch(*args, row_base=base)
                    else:
                        _launch_parent(lib, *args, row_base=base)

                parent = _parent_lib()
                t_par, t_alone = ((None, graph_ms(alone)) if parent is None else
                                  _in_turns(lambda: alone(parent), alone, graph_ms))
                scratch = [[t.clone() for t in lv] for lv in loc0]
                times.append(dict(wrapper=t_wrap, alone=t_alone, parent=t_par,
                                  plain=cuda_ms(lambda: ak.fused_adam_shard_plain(
                                      *scratch, None, g_loc, lr, bc1, bc2, scales, base,
                                      pre=pre, **kw), iters=3),
                                  m_sh=int(rows_loc.shape[0]),
                                  used=[max(0, min(nu - k * b, b)) for nu in n_used]))
                del ref, scratch, tim, pre
            # the blocks concatenated against one unsharded K2 launch: rows
            # with at most one entry bit-equal; every row of f32 tables within
            # phase 2's tolerance plus the sum-order spread (both sum a row's
            # entries by atomics), bf16 elements but for one-ulp ties
            got = [[torch.cat([blk[t][l] for blk in blocks]) for l in range(3)]
                   for t in range(3)]
            for t in range(3):
                for l in range(3):
                    bits = torch.int16 if got[t][l].itemsize == 2 else torch.int32
                    s_ = single[l]
                    assert torch.equal(got[t][l][s_].view(bits), whole[t][l][s_].view(bits)), \
                        f"{n} shards vs K2 ({variant}): table {t} level {l} differs on rows " \
                        "with at most one entry"
            if variant == "f32":
                _check_f32(got, whole, t0, n_used, moved_share=None, spread=spread_w)
            elif variant == "bf16m":
                _check_f32(got[:1], whole[:1], t0[:1], n_used, names="p", moved_share=None,
                           spread=spread_w[:1])
                _check_bf16_ties(got[1:], whole[1:], t0[1:], n_used, moved_share=None)
            else:
                _check_bf16_ties(got, whole, t0, n_used, names="pmv", moved_share=None)
            del got
            worst = max(range(n), key=lambda k: times[k]["alone"])
            tm = times[worst]
            pb, mb = (t.itemsize for t in dtypes[variant])
            # the fullest shard's step: its whole blocks in and out, its entries
            elems = 3 * b * D
            nbytes = 2 * (pb + 2 * mb) * elems + tm["m_sh"] * (4 + 4 + 4 * D)
            flops = (13 + (10 if variant == "bf16p" else 0)) * elems + tm["m_sh"] * D
            bound, by = (1e3 * max(nbytes / H100_BYTES_PER_S, flops / H100_F32_FLOPS),
                         "bytes" if nbytes / H100_BYTES_PER_S >= flops / H100_F32_FLOPS
                         else "operations")
            entry[n] = dict(ms=tm["wrapper"], kernel_only_ms=tm["alone"], plain_ms=tm["plain"],
                            bound_ms=bound, bound_by=by, max_abs_err=max(errs),
                            parent_kernel_ms=tm["parent"],
                            shard_kernel_ms=[round(x["alone"], 4) for x in times],
                            parent_shard_kernel_ms=None if tm["parent"] is None else
                            [round(x["parent"], 4) for x in times])
            par = ("" if tm["parent"] is None else
                   f"the parent's {tm['parent']:.4f} ms (in turns; all shards "
                   f"{entry[n]['parent_shard_kernel_ms']}), ")
            print(f"[kernels] K2 shard fused_adam_multi_shard{ak._SUFFIX[variant]} ({n} shards "
                  f"of {b} rows x 3 levels, entries per shard {[x['m_sh'] for x in times]} "
                  f"incl. ~10% pads): each shard vs plain max_abs_err {max(errs):.3e} (phase 2's "
                  f"checks on every row: {_SHARD_CHECKS[variant]}; single-entry rows bit-equal)"
                  f", {n} shards concatenated = unsharded K2 (single-entry rows bit-equal, "
                  + ("p, m and v one-ulp ties" if variant == "bf16p" else _SHARD_CHECKS[variant])
                  + f"); fullest shard {worst}: wrapper {tm['wrapper']:.4f} ms, kernel alone "
                  f"{tm['alone']:.4f} ms (all shards {entry[n]['shard_kernel_ms']}), {par}plain "
                  f"{tm['plain']:.4f} ms, library none, bound {bound:.4f} ms ({by}), "
                  f"{bound / tm['alone']:.0%} of bound")
            del blocks
            torch.cuda.empty_cache()
        del spread_w
        e2, e4 = entry[shard_counts[0]], entry[shard_counts[-1]]
        rows_json.append(dict(
            name="fused_adam_multi_shard" + ak._SUFFIX[variant], route="cuda", source=SOURCE,
            replaces=SHARD_TPU, variant=variant, max_abs_err=max(e2["max_abs_err"],
                                                                  e4["max_abs_err"]),
            ms=e2["ms"], kernel_only_ms=e2["kernel_only_ms"], plain_ms=e2["plain_ms"],
            bound_ms=e2["bound_ms"], bound_by=e2["bound_by"], library_ms=None,
            parent_kernel_ms=e2["parent_kernel_ms"], shards=shard_counts[0],
            ms_4_shards=e4["ms"], kernel_only_ms_4_shards=e4["kernel_only_ms"],
            plain_ms_4_shards=e4["plain_ms"],
            shard_kernel_ms_4_shards=e4["shard_kernel_ms"],
            parent_shard_kernel_ms_4_shards=e4["parent_shard_kernel_ms"],
            parent_kernel_ms_4_shards=e4["parent_kernel_ms"], bound_ms_4_shards=e4["bound_ms"]))
        del whole, t0
        torch.cuda.empty_cache()
    return rows_json


# phase 9's training runs on the bench world: (tag, label, table layout,
# fused windows, bf16 moments, bf16 tables, the update's launch key, steps,
# feature_update); 30 and 20 steps keep the whole smoke within its time
MULTI_RUNS = (
    ("a", "replicated tables, iid K2", "replicated", False, False, False,
     "fused_adam_multi", 30, "pallas"),
    ("b", "replicated tables, bf16 map mode on fused windows (K2 + SR)", "replicated", True,
     True, True, "fused_adam_multi_bf16p", 30, "pallas"),
    ("c", "row-sharded tables, routed fused windows, f32 (K2 shard)", "rows", True, False,
     False, "fused_adam_multi_shard", 30, "pallas"),
    ("d", "row-sharded tables, routed fused windows, bf16 tables (K2 shard + SR)", "rows",
     True, True, True, "fused_adam_multi_shard_bf16p", 30, "pallas"),
    ("e", "row-sharded tables, routed fused windows, bf16 moments (K2 shard)", "rows", True,
     True, False, "fused_adam_multi_shard_bf16m", 20, "pallas"),
)
# phase 10's: row-sharded tables on iid batches, the entries routed live each
# step (no launch key: the lazy update runs no kernel)
ROWS_IID_RUNS = (
    ("f", "row-sharded tables, iid batches routed live, fused (K2 shard on a live "
     "csrc/entry_prep.cu prep)", "rows", False, False, False, "fused_adam_multi_shard", 50,
     "fused"),
    ("g", "row-sharded tables, iid batches routed live, sparse (lazy Adam on the rows' ranks)",
     "rows", False, False, False, None, 50, "sparse"),
)


def _join_ranks(rank, world, port, backend):
    import datetime

    import torch
    import torch.distributed as dist

    from shine_mapping_tpu_torch.parallel import mesh

    dev = torch.device("cuda", rank if backend == "nccl" else 0)
    torch.cuda.set_device(dev)
    # a rank that waits 5 minutes on a collective fails the phase, not the smoke's limit
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(minutes=5))
    return mesh.data_group(dev)


def _step_one_check(tag, first, ref_tabs, init, captured, s, bc, variant):
    """The routed run's tables after its first step against the one-rank
    run's after the same first step, from the same state: f32 within phase
    2's tolerance plus the sum-order spread; bf16 elements bit-equal on
    rows with at most one entry.  Returns (max |d p|, share of p bit-equal)."""
    import torch

    from shine_mapping_tpu_torch.ops import adam_kernel as ak

    rows_l, g_l = captured
    C = [t.shape[0] for t in init[0]]
    single = _single_rows(rows_l, C, s.n_used)
    err, equal, total = 0.0, 0, 0
    for l in range(len(C)):
        a = [x[l] for x in first]
        b = [x[l] for x in ref_tabs]
        err = max(err, float((a[0].float() - b[0].float()).abs().max()))
        equal += int((a[0].view(torch.int16 if a[0].itemsize == 2 else torch.int32)
                      == b[0].view(torch.int16 if b[0].itemsize == 2 else torch.int32)).sum())
        total += a[0].numel()
        s_ = single[l]
        for t in range(3):
            if a[t].dtype == torch.bfloat16:
                diff = int((a[t][s_].view(torch.int16) != b[t][s_].view(torch.int16)).sum())
                assert diff == 0, f"({tag}) table {t} level {l}: {diff} elements of rows with " \
                    "at most one entry differ from the one-rank run"
        if variant == "bf16p":
            continue
        lr_l = float(s.lr) * (s.lr_level_reduce_ratio ** l)
        sp = _sum_order_spread([x[l] for x in init], rows_l[l], g_l[l], lr_l, bc[0], bc[1],
                               s.n_used[l], grads_bf16=variant != "f32")
        for t in range(3 if variant == "f32" else 1):
            x, y, x0 = a[t].float(), b[t].float(), init[t][l].float()
            atol = 1e-6 if t else min(1e-6, 1e-5 * float(x0.abs().max()))
            allow = atol + 1e-5 * y.abs() + sp[t][0]
            bad = ~((x - y).abs() <= allow)
            assert not bad.any(), f"({tag}) table {t} level {l}: {int(bad.sum())} elements " \
                "past phase 2's tolerance and the sum-order spread after the first step"
    return err, equal / total


def _multi_rank(rank, world, port, backend, out_path, runs=MULTI_RUNS):
    """Phase 9's training runs (``runs``: phase 10's) on one rank (module doc)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from shine_mapping_tpu_torch.config import SHINEConfig
    from shine_mapping_tpu_torch.ops import adam_kernel as ak
    from shine_mapping_tpu_torch.parallel import comm, mesh
    from shine_mapping_tpu_torch.train import trainer
    from shine_mapping_tpu_torch.train.optimizer import (FEATURES, bias_corrections,
                                                         init_opt_state)

    grp = _join_ranks(rank, world, port, backend)
    dev = grp.device
    cfg = SHINEConfig().load(ICRA_CONFIG)
    t0 = time.perf_counter()
    grid, pool, _ = build_bench_world(cfg, dev)
    pool_dev, n_valid = trainer.pool_to_device(pool, len(pool), device=dev)
    pre = trainer.precompute_pool_lookups(grid.tables, pool_dev["coord"], grid.levels,
                                          [f.shape[0] for f in grid.features])
    init = [f.clone() for f in grid.features]
    shapes = [tuple(f.shape) for f in init]
    k = min(65536, n_valid)
    fixed = torch.arange(k, device=dev) * n_valid // k
    out = {"world_s": time.perf_counter() - t0}

    def fresh(s, mbf, pbf):
        params = trainer.init_params(cfg, grid, torch.Generator(device=dev).manual_seed(0))
        params[FEATURES] = [f.to(torch.bfloat16) if pbf else f.clone() for f in init]
        return params, init_opt_state(params, moments_bf16=mbf)

    def whole(params, opt, rows):
        ts = (params[FEATURES], opt.m[FEATURES], opt.v[FEATURES])
        return [mesh.gather_table_rows(grp, t) if rows else [x.clone() for x in t] for t in ts]

    def fixed_loss(params, feats, s):
        p = dict(params, **{FEATURES: feats})
        return float(trainer.batch_loss(p, grid.tables, pool_dev, fixed, s)["total_loss"])

    for tag, label, layout, windows, mbf, pbf, key, steps, update in runs:
        rows = layout == "rows"
        variant = "bf16p" if pbf else ("bf16m" if mbf else "f32")
        s = trainer.TrainSettings.from_config(cfg, grid.levels, feature_update=update,
                                              fuse_update_levels=not windows,
                                              n_used=trainer.used_rows_for(grid))
        params, opt = fresh(s, mbf, pbf)
        params, opt, _ = mesh.place_training_state(grp, params, opt, table_sharding=layout)
        torch.cuda.synchronize()
        t_win = time.perf_counter()
        win = None
        if windows:
            win = trainer.precompute_batch_windows(
                pre, n_valid, torch.Generator(device=dev).manual_seed(0), s, shapes, fused=True,
                shards=world if rows else 0, rank=rank if rows else None,
                deterministic=not rows)
        torch.cuda.synchronize()
        t_win = time.perf_counter() - t_win
        before = fixed_loss(params, whole(params, opt, rows)[0], s)
        gen = torch.Generator(device=dev).manual_seed(0)
        torch.cuda.reset_peak_memory_stats(dev)
        ak.reset_launch_counts()  # this run of phase 9's path starts here
        comm.reset_counts()
        chunks = [1, 9] + [10] * ((steps - 10) // 10)
        times, losses, replicas, first, start = [], [], True, None, 0
        for n in chunks:
            torch.cuda.synchronize()
            t_c = time.perf_counter()
            params, opt, aux = trainer.train_chunk(
                params, opt, grid.tables, pool_dev, n_valid, start, gen, s, n, group=grp,
                pre_lookups=pre, batch_windows=win)
            losses.append(float(aux["mean"]["total_loss"]))  # syncs
            times.append((time.perf_counter() - t_c) / n * 1e3)
            start += n
            saved = {op: list(c) for op, c in comm.COUNTS.items()}
            if not rows:  # every rank's tables, moments and decoders, the same bits
                replicas &= mesh.replicas_equal(grp, mesh.state_tensors(params, opt))
            elif start == 1:
                first = whole(params, opt, rows)
            comm.COUNTS.update(saved)  # the checks' gathers are not the run's
        counts = dict(ak.LAUNCHES)  # read right after the run
        comm_counts = {op: list(c) for op, c in comm.COUNTS.items()}
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        final = whole(params, opt, rows)
        after = fixed_loss(params, final[0], s)
        busy = nccl = None
        if tag != "e":  # the device time of 10 more steps (torch.profiler, this rank's ops)
            from torch.profiler import ProfilerActivity, profile

            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                params, opt, aux = trainer.train_chunk(
                    params, opt, grid.tables, pool_dev, n_valid, start, gen, s, 10, group=grp,
                    pre_lookups=pre, batch_windows=win)
                torch.cuda.synchronize()
            # NCCL's kernels spin on the card while they wait for the other
            # ranks: their time is the collectives', not work
            dev_ev = [e for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA]
            busy = sum(e.device_time_total for e in dev_ev
                       if "nccl" not in e.name.lower()) / 1e3 / 10
            nccl = sum(e.device_time_total for e in dev_ev
                       if "nccl" in e.name.lower()) / 1e3 / 10
        per_rank = [None] * world
        dist.all_gather_object(per_rank, dict(launches=counts, peak=peak, comm=comm_counts,
                                              busy=busy, nccl=nccl))
        res = dict(label=label, layout=layout, steps=steps, before=before, after=after,
                   losses=losses, ms=float(np.median(times[2:])), first_ms=times[:2],
                   windows_s=t_win, per_rank=per_rank, replicas=replicas if not rows else None,
                   key=key, E=win.route.E if win is not None and rows else None)
        if rows and rank == 0:
            # the one-rank run of the same windows (iid: the same draws) from
            # the same state
            ref_p, ref_o = fresh(s, mbf, pbf)
            win_1 = None if win is None else trainer.precompute_batch_windows(
                pre, n_valid, None, s, shapes, fused=True, window_indices=win.idx)
            captured, seg = [], []
            real, real_seg = ak.fused_adam_multi, trainer.sparse_adam.segment_by_row

            def capture(ps, ms, vs, rows_list, g_list, *a, **kw):
                if not captured:
                    captured.append(([r.reshape(-1).clone() for r in rows_list],
                                     [g.reshape(-1, g.shape[-1]).clone() for g in g_list]))
                return real(ps, ms, vs, rows_list, g_list, *a, **kw)

            def capture_seg(corners, contribs, table_rows):  # the lazy update's entries
                if len(seg) < len(shapes):
                    seg.append((corners.reshape(-1).clone(),
                                contribs.reshape(-1, contribs.shape[-1]).clone()))
                    if len(seg) == len(shapes):
                        captured.append(tuple(map(list, zip(*seg))))
                return real_seg(corners, contribs, table_rows)

            ak.fused_adam_multi, trainer.sparse_adam.segment_by_row = capture, capture_seg
            try:
                gen_1 = torch.Generator(device=dev).manual_seed(0)
                ref_p, ref_o, _ = trainer.train_chunk(ref_p, ref_o, grid.tables, pool_dev,
                                                      n_valid, 0, gen_1, s, 1,
                                                      pre_lookups=pre, batch_windows=win_1)
            finally:
                ak.fused_adam_multi, trainer.sparse_adam.segment_by_row = real, real_seg
            ref_first = whole(ref_p, ref_o, False)
            init_tabs = [[f.to(torch.bfloat16) if pbf else f.clone() for f in init],
                         [torch.zeros_like(x) for x in ref_first[1]],
                         [torch.zeros_like(x) for x in ref_first[2]]]
            err1, eq1 = _step_one_check(tag, first, ref_first, init_tabs, captured[0], s,
                                        bias_corrections(1), variant)
            ref_p, ref_o, _ = trainer.train_chunk(ref_p, ref_o, grid.tables, pool_dev, n_valid,
                                                  1, gen_1, s, steps - 1, pre_lookups=pre,
                                                  batch_windows=win_1)
            ref_final = whole(ref_p, ref_o, False)
            res.update(step1_err=err1, step1_equal=eq1,
                       ref_after=fixed_loss(ref_p, ref_final[0], s),
                       final_err=max(float((a.float() - b.float()).abs().max())
                                     for a, b in zip(final[0], ref_final[0])))
            del ref_p, ref_o, win_1, ref_first, ref_final
        dist.barrier()
        out[tag] = res
        del params, opt, win, final, first
        torch.cuda.empty_cache()
    if rank == 0:
        torch.save(out, out_path)
    dist.barrier()
    dist.destroy_process_group()


def phase_multi_train(runs=MULTI_RUNS):
    """Phase 9's training runs and phase 10's (``runs``: any of
    ``MULTI_RUNS`` and ``ROWS_IID_RUNS``, in one spawn on one bench world)
    over the ranks the cards allow: two ranks on one card over gloo, or one
    rank a card over NCCL.  Returns per run tag the launches summed over the
    ranks."""
    import math
    import tempfile

    import torch
    import torch.multiprocessing as mp

    from shine_mapping_tpu_torch.parallel import mesh

    n_cards = torch.cuda.device_count()
    world, backend = (n_cards, "nccl") if n_cards >= 2 else (2, "gloo")
    phase = {r[0]: "incre-multi" if r in ROWS_IID_RUNS else "multi" for r in runs}
    tag = phase[runs[0][0]]
    print(f"[{tag}] {world} ranks over {backend} on {n_cards} card(s); the ICRA MaiCity "
          f"config ({ICRA_CONFIG}) on the bench world, runs {[r[0] for r in runs]} at "
          f"{[r[7] for r in runs]} steps")
    with tempfile.TemporaryDirectory(prefix="smoke_multi_") as tmp:
        out = os.path.join(tmp, "multi.pt")
        t0 = time.perf_counter()
        mp.start_processes(_multi_rank, args=(world, mesh.free_port(), backend, out, runs),
                           nprocs=world, start_method="spawn", join=True)
        res = torch.load(out, weights_only=False)
    print(f"[{tag}] ranks ran in {time.perf_counter() - t0:.1f} s (bench world built in "
          f"{res['world_s']:.1f} s a rank)")
    launches = {}
    for run in runs:
        t = run[0]
        r = res[t]
        tag = phase[t]
        key, live = r["key"], run[2] == "rows" and not run[3]
        per = [p["launches"] for p in r["per_rank"]]
        n_launch = [c[key] if key else 0 for c in per]
        assert all(c == (r["steps"] if key else 0) for c in n_launch), \
            f"({t}) {key}: {n_launch} launches per rank, want {r['steps']} each"
        if live and key:  # one live prep a step (csrc/entry_prep.cu)
            assert all(c["entry_prep"] == r["steps"] for c in per), \
                f"({t}) entry_prep: {[c['entry_prep'] for c in per]} launches per rank"
        others = {k: n for c in per for k, n in c.items() if k not in (key, "entry_prep") and n}
        assert not others, f"({t}) other kernels launched: {others}"
        launches[t] = {}
        for c in per:
            for k2, n2 in c.items():
                launches[t][k2] = launches[t].get(k2, 0) + n2
        assert all(math.isfinite(x) for x in r["losses"]), f"({t}) non-finite loss"
        assert r["after"] < r["before"], f"({t}) the fixed-sample loss did not fall"
        comm0 = r["per_rank"][0]["comm"]
        busy = [p["busy"] for p in r["per_rank"]]
        if busy[0] is None:
            idle = "not measured"
        else:  # ranks sharing a card add up on it
            per_card = sum(busy) if backend == "gloo" else max(busy)
            idle = (f"device busy {[round(b, 3) for b in busy]} ms/step a rank, the "
                    f"{'card' if backend == 'gloo' else 'busiest card'} idle "
                    f"{1 - per_card / r['ms']:.3f}")
            if backend == "nccl":
                idle += (f" (NCCL kernels, waits included, "
                         f"{[round(p['nccl'], 3) for p in r['per_rank']]} ms/step a rank)")
        comm_s = ", ".join(f"{op} {c[0] / r['steps']:.2f} calls {c[1] / r['steps'] / 2**20:.3f} "
                           "MiB" for op, c in comm0.items() if c[0])
        line = (f"[{tag}] ({t}) {r['label']}, {backend}: {r['steps']} steps, {r['ms']:.3f} "
                f"ms/step (median of chunks 3+; first two {[round(x, 1) for x in r['first_ms']]}),"
                f" launches per rank {n_launch} ({key}), collectives per step on rank 0: "
                f"{comm_s}; peak GiB per rank {[round(p['peak'], 3) for p in r['per_rank']]}; "
                f"fixed-sample loss {r['before']:.6f} -> {r['after']:.6f}; windows built in "
                f"{r['windows_s']:.2f} s; {idle}")
        if r["replicas"] is not None:
            assert r["replicas"], f"({t}) the replicas parted"
            line += "; replica checksums equal on every rank after every chunk"
        else:
            gap = abs(r["after"] - r["ref_after"])
            drop = r["before"] - r["ref_after"]
            assert gap <= 0.05 * drop, \
                f"({t}) fixed-sample loss {r['after']} vs one rank {r['ref_after']}"
            line += ((f" (routed E {r['E']})" if r["E"] else " (cells padded to each step's "
                      "largest)") + "; against the one-rank run of the same windows or draws: "
                     f"after step 1 tables within phase 2's tolerance plus the sum-order spread"
                     f", bf16 elements bit-equal on rows with at most one entry, p max |d| "
                     f"{r['step1_err']:.3e}, {r['step1_equal']:.6f} of p bit-equal; after "
                     f"{r['steps']} steps fixed-sample loss {r['after']:.6f} vs "
                     f"{r['ref_after']:.6f} (within 5 % of the drop), p max |d| "
                     f"{r['final_err']:.3e}")
        print(line)
    return launches


def _launches_of(per_run, runs):
    """The launches of ``runs`` in :func:`phase_multi_train`'s result,
    summed."""
    out = {}
    for r in runs:
        for k, n in per_run[r[0]].items():
            out[k] = out.get(k, 0) + n
    return out




def _cli_check_rank(rank, world, port, backend, cfg, ckpt_path, out_path):
    """On the two-rank run's world and checkpoint: the sharded data phase,
    data-parallel meshing of the map's box, and the checkpoint loaded, cut
    into row blocks, gathered and written again (rank 0 keeps the results)."""
    import torch
    import torch.distributed as dist

    from shine_mapping_tpu_torch.cli.common import build_grid
    from shine_mapping_tpu_torch.data.dataset import LiDARDataset
    from shine_mapping_tpu_torch.mesher import Mesher
    from shine_mapping_tpu_torch.parallel import mesh
    from shine_mapping_tpu_torch.parallel.ingest import process_frames_sharded
    from shine_mapping_tpu_torch.train import trainer
    from shine_mapping_tpu_torch.train.optimizer import FEATURES, init_opt_state
    from shine_mapping_tpu_torch.utils import checkpoint as ckpt

    grp = _join_ranks(rank, world, port, backend)
    cfg.device = str(grp.device)
    t0 = time.perf_counter()
    ds = LiDARDataset(cfg, build_grid(cfg))
    process_frames_sharded(ds, ds.frame_ids(), grp)
    t_data = time.perf_counter() - t0
    pool = {f: getattr(ds.pool, f) for f in ("coord", "sdf_label", "weight", "time")}
    octree = ds.grid.state_dict()
    skeleton = trainer.init_params(cfg, build_grid(cfg))
    grid, params, opt, iters = ckpt.load_checkpoint(ckpt_path, skeleton,
                                                    init_opt_state(skeleton))
    grid.cast_features(torch.bfloat16)  # the bf16 map, as the driver resumes it
    params[FEATURES] = list(grid.features)
    mesher = Mesher(cfg, grid, params["geo"], params["sem"], group=grp)
    vox, origin = mesher.grid_shape_from_bbx(ds.map_bbx, cfg.mc_res_m)
    sdf, _, mask = mesher.query_grid_lattice(vox, origin, cfg.mc_res_m)
    t_query = mesher.timing["query"]
    params, opt, _ = mesh.place_training_state(grp, params, opt, table_sharding="rows")
    grid.features = mesh.gather_table_rows(grp, params[FEATURES])
    ckpt.save_checkpoint(out_path + ".npz", grid, params, opt, iters, grp)
    if rank == 0:
        torch.save({"pool": pool, "octree": octree, "sdf": sdf, "mask": mask, "vox": vox,
                    "origin": origin, "data_s": t_data, "query_s": t_query}, out_path)
    dist.barrier()
    dist.destroy_process_group()


def phase_multi_cli(iters=500, n_frames=20):
    """[multi] cli: the batch CLI with tpu.mesh_shape 2, row-sharded tables
    and the bf16 map mode on phase 6's world; then its sharded data phase,
    meshing and checkpoint held against one rank's."""
    import dataclasses
    import tempfile

    import numpy as np
    import torch
    import torch.multiprocessing as mp

    from shine_mapping_tpu_torch.cli.common import build_grid
    from shine_mapping_tpu_torch.cli.shine_batch import run_shine_mapping_batch
    from shine_mapping_tpu_torch.data.dataset import LiDARDataset
    from shine_mapping_tpu_torch.eval.metrics import eval_mesh
    from shine_mapping_tpu_torch.mesher import Mesher
    from shine_mapping_tpu_torch.parallel import mesh
    from shine_mapping_tpu_torch.train import trainer
    from shine_mapping_tpu_torch.train.optimizer import init_opt_state
    from shine_mapping_tpu_torch.utils import checkpoint as ckpt

    backend = "nccl" if torch.cuda.device_count() >= 2 else "gloo"
    bf16 = dict(feature_update="pallas", moments_bf16=True, batch_windows=True,
                params_bf16=True)
    with tempfile.TemporaryDirectory(prefix="smoke_multi_cli_") as tmp:
        world = os.path.join(tmp, "world")
        _, gt_path = write_synth_sequence(world, n_frames)
        if MAP_B not in MAP_SCORES:  # phase 6 did not run: its run B here
            cfg_b = _map_config(world, os.path.join(tmp, "b"), iters, **bf16)
            _map_run(MAP_B, cfg_b, gt_path, "fused_adam_multi_bf16p", 1, 1)
        cfg = _map_config(world, os.path.join(tmp, "m"), iters, mesh_shape=2,
                          table_sharding="rows", shard_ingest=True, **bf16)
        t0 = time.perf_counter()
        run_path, _, _ = run_shine_mapping_batch(cfg=cfg, backend=backend)
        wall = time.perf_counter() - t0
        with open(os.path.join(run_path, "metrics.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        ms = [r["timing(s)/per_iter"] * 1e3 for r in recs]
        m = eval_mesh(os.path.join(run_path, f"mesh/mesh_iter_{iters}.ply"), gt_path, **EVAL_KW)
        gap = abs(m["F-score (%)"] - MAP_SCORES[MAP_B])
        print(f"[multi] cli: 2 ranks over {backend}, table_sharding rows, bf16 map mode, "
              f"{iters} steps at {float(np.median(ms[1:] or ms)):.3f} ms/step (rank 0's "
              f"metrics.jsonl), data phase {recs[-1]['phase(s)/data']:.2f} s (sharded), run "
              f"{wall:.1f} s; eval_mesh F-score {m['F-score (%)']:.3f} %, Chamfer-L1 "
              f"{m['Chamfer_L1 (m)']:.4f} m (bars: < {MAP_BARS[0]} m, > {MAP_BARS[1]} %), "
              f"{gap:.3f} points from phase 6's run B ({MAP_SCORES[MAP_B]:.3f} %; bar 5)")
        assert m["Chamfer_L1 (m)"] < MAP_BARS[0] and m["F-score (%)"] > MAP_BARS[1], m
        assert gap <= 5.0, f"two ranks {gap:.3f} points from run B"
        src = os.path.join(run_path, "model", "model_final.npz")
        out = os.path.join(tmp, "checks.pt")
        cfg1 = dataclasses.replace(cfg, mesh_shape=1)
        mp.start_processes(_cli_check_rank, args=(2, mesh.free_port(), backend, cfg1, src, out),
                           nprocs=2, start_method="spawn", join=True)
        got = torch.load(out, weights_only=False)
        # one process: the pipelined data phase (the same per-frame rng)
        t0 = time.perf_counter()
        ds = LiDARDataset(cfg1, build_grid(cfg1))
        ds.process_frames_pipelined(ds.frame_ids(), workers=4)
        t_one = time.perf_counter() - t0
        for f, a in got["pool"].items():
            assert np.array_equal(a, getattr(ds.pool, f)), f"sharded ingest: pool {f} differs"
        want = ds.grid.state_dict()
        for k in want:
            assert np.array_equal(np.asarray(got["octree"][k]), np.asarray(want[k])), \
                f"sharded ingest: octree {k} differs"
        skeleton = trainer.init_params(cfg1, build_grid(cfg1))
        grid, params, _, _ = ckpt.load_checkpoint(src, skeleton, init_opt_state(skeleton))
        grid.cast_features(torch.bfloat16)
        one_m = Mesher(cfg1, grid, params["geo"])
        sdf, _, mask = one_m.query_grid_lattice(got["vox"], got["origin"], cfg1.mc_res_m)
        assert np.array_equal(got["mask"], mask), "data-parallel mesher: masks differ"
        assert np.array_equal(got["sdf"], sdf), "data-parallel mesher: sdf differs"
        a, b = np.load(src), np.load(out + ".npz")
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert np.array_equal(a[k], b[k]), f"checkpoint round trip: {k} differs"
        print(f"[multi] cli: sharded ingest ({len(ds.pool)} samples, {got['data_s']:.2f} s on "
              f"2 ranks; one process {t_one:.2f} s) bit-equal to the one-process pool and "
              f"octree; data-parallel mesher ({int(np.prod(got['vox']))} voxels, query "
              f"{got['query_s']:.3f} s on 2 ranks, {one_m.timing['query']:.3f} s on one) masks "
              f"and sdf equal to one rank's; the rank-0 checkpoint loaded, cut into 2 row "
              f"blocks, gathered and written again: {len(a.files)} keys bit-equal")
    return m


def phase_multi(runs=MULTI_RUNS):
    """Phase 9 ("multi"): K2's row-sharded caller against its plain version
    and against unsharded K2, the training runs over several ranks (with
    ``runs`` beyond ``MULTI_RUNS``: phase 10's in the same spawn), the
    two-rank batch CLI.  Returns (the shard kernels' JSON entries, phase
    9's runs' launches summed over ranks, every run's launches by tag)."""
    t0 = time.perf_counter()
    rows = phase_shard_kernels()
    per_run = phase_multi_train(runs)
    launches = _launches_of(per_run, MULTI_RUNS)
    phase_multi_cli()
    for r in rows:
        r["launches"] = launches.get(r["name"], 0)
    print(f"[multi] phase 9 took {time.perf_counter() - t0:.1f} s")
    return rows, launches, per_run


# ----------------------------------------------------------------- phase 10


def _live_cells(rows_l, g_l, sizes, k, n):
    """Shard k's entries of a step as a live routing delivers them: per
    level the found entries whose rows lie in its blocks, from each of n
    sample ranks (the step's entries cut into n contiguous shares) in entry
    order, each rank's cell padded to the step's largest cell E (a multiple
    of 8; pad rows -1, pad gradients NaN: never read).  Returns (per level
    its (n E,) block rows, the gradients (L n E, D) level-major, per level
    (local rows, grads) of the real entries)."""
    import torch

    cells, per = [], []
    for rows, g, C in zip(rows_l, g_l, sizes):
        b = C // n
        r = rows.long()
        sel = (r // b == k) & (r != C - 1)
        per.append((r[sel] - k * b, g[sel]))
        share = -(-r.shape[0] // n)
        cells.append([((r[s0:s0 + share] - k * b)[sel[s0:s0 + share]],
                       g[s0:s0 + share][sel[s0:s0 + share]])
                      for s0 in range(0, r.shape[0], share)])
    E = max(8, -(-max(c[0].shape[0] for lv in cells for c in lv) // 8) * 8)
    rows_list, gs = [], []
    for lv in cells:
        rr, gg = [], []
        for r, g in lv:
            rr.append(torch.cat([r, r.new_full((E - r.shape[0],), -1)]))
            gg.append(torch.cat([g, g.new_full((E - r.shape[0], g.shape[1]), float("nan"))]))
        rows_list.append(torch.cat(rr).to(torch.int32).contiguous())
        gs.append(torch.cat(gg))
    return rows_list, torch.cat(gs).contiguous(), per


def phase_live_shard_kernel(C=1 << 22, corners=(3_180_000, 3_070_000, 2_400_000), M=65536,
                            n=2):
    """[kernels] K2's row-sharded caller on a live prep (the iid step of
    row-sharded tables, runs (f) and (i)): for each of 2 shards the entries
    a live routing delivers it (phase 9's shapes), binned per step by
    csrc/entry_prep.cu (``entry_prep_shard``: tiles and (row, entry) pairs
    equal to the sorted ``entry_prep_local``'s, pads excluded and not
    dropped), then ``fused_adam_shard`` on that prep (not sorted by row:
    each row's entries summed by the kernel's atomics) against
    ``fused_adam_shard_plain`` on the same prep: f32 p, m, v within phase
    2's tolerance plus the sum-order spread, bf16 moments one-ulp ties as
    phase 2 counts them, rows with at most one entry bit-equal.  Times of
    the fullest shard: prep, wrapper, kernel alone, plain, the library call
    (``index_add_`` + fused ``torch.optim.Adam`` over the shard's blocks,
    the yardstick of the row-sharded f32 row), bound.  Returns (max error,
    library ms)."""
    import numpy as np
    import torch

    from shine_mapping_tpu_torch.ops import adam_kernel as ak

    dev = torch.device(DEVICE)
    D, L = 8, 3
    sizes = [C] * L
    n_used = list(ak.used_rows_hint(corners, sizes))
    lr, bc1, bc2 = 0.01, 1 - 0.9 ** 5, 1 - 0.99 ** 5
    scales = [1.0, 0.5, 0.25]
    lrs = [lr * x for x in scales]
    rng = np.random.default_rng(2)
    tabs0, rows_l, g_l = _kernel_inputs(rng, sizes, n_used, M, D, dev)
    b = C // n
    single = _single_rows(rows_l, sizes, n_used)
    worst, out = None, 0.0
    for k in range(n):
        rows_list, g_loc, per = _live_cells(rows_l, g_l, sizes, k, n)
        base = ak.shard_row_base([(C, D)] * L, n, k)
        pre = ak.entry_prep_shard(rows_list, [b] * L, D)
        glob = torch.cat([torch.where(r >= 0, r.long() + l * b, -1)
                          for l, r in enumerate(rows_list)])
        plain_pre = ak.entry_prep_local(glob, [b] * L, D)
        torch.cuda.synchronize()
        # the card's prep is binned by atomics (a rehearsal's CPU prep is sorted)
        assert pre.sorted_by_row == (dev.type == "cpu") and int(pre.dropped) == 0
        _check_prep(pre, plain_pre, pre.tile_off.shape[0] - 1)
        loc0 = [[t[k * b:(k + 1) * b].clone() for t in lv] for lv in tabs0]
        single_k = [x[k * b:(k + 1) * b] for x in single]
        spread = [[], [], []]
        for l, (r_l, gg) in enumerate(per):
            sp = _sum_order_spread([x[l] for x in loc0], r_l, gg, lrs[l], bc1, bc2, b)
            for t in range(3):
                spread[t].append(sp[t][0])
        for variant in ("f32", "bf16m"):
            md = torch.float32 if variant == "f32" else torch.bfloat16
            t0 = [loc0[0], [t.to(md) for t in loc0[1]], [t.to(md) for t in loc0[2]]]
            kw = dict(grads_bf16=variant != "f32")
            kern = [[t.clone() for t in lv] for lv in t0]
            ref = [[t.clone() for t in lv] for lv in t0]
            ak.fused_adam_shard(*kern, None, g_loc, lr, bc1, bc2, scales, base, pre=pre, **kw)
            ak.fused_adam_shard_plain(*ref, None, g_loc, lr, bc1, bc2, scales, base, pre=pre,
                                      **kw)
            torch.cuda.synchronize()
            if variant == "f32":
                err = _check_f32(kern, ref, t0, [b] * L, single=single_k, moved_share=None,
                                 spread=spread)
            else:
                sp_b = [[], [], []]
                for l, (r_l, gg) in enumerate(per):
                    sp = _sum_order_spread([t0[0][l], t0[1][l].float(), t0[2][l].float()], r_l,
                                           gg, lrs[l], bc1, bc2, b, grads_bf16=True)
                    sp_b[0].append(sp[0][0])
                err = _check_f32(kern[:1], ref[:1], t0[:1], [b] * L, names="p",
                                 single=single_k, moved_share=None, spread=sp_b[:1])
                err = max(err, _check_bf16_ties(kern[1:], ref[1:], t0[1:], [b] * L,
                                                moved_share=None)[0])
            out = max(out, err)
            if variant != "f32":
                continue
            tim = [[t.clone() for t in lv] for lv in t0]

            def alone(lib=None):
                args = ("f32", *tim, [g_loc] * L, [0] * L, pre, [b] * L,
                        [l * b for l in range(L)], lrs, 0.9, 0.99, bc1, bc2, 1e-15, False, 0)
                if lib is None:
                    ak._launch(*args, row_base=base)
                else:
                    _launch_parent(lib, *args, row_base=base)

            parent = _parent_lib()
            t_par, t_alone = ((None, graph_ms(alone)) if parent is None else
                              _in_turns(lambda: alone(parent), alone, graph_ms))
            m_real = sum(int(r.shape[0]) for r, _ in per)
            t = dict(k=k, alone=t_alone, parent=t_par,
                     wrapper=cuda_ms(lambda: ak.fused_adam_shard(*tim, None, g_loc, lr, bc1,
                                                                 bc2, scales, base, pre=pre)),
                     prep=cuda_ms(lambda: ak.entry_prep_shard(rows_list, [b] * L, D)),
                     sorted_prep=cuda_ms(lambda: ak.entry_prep_local(glob, [b] * L, D), iters=5),
                     plain=cuda_ms(lambda: ak.fused_adam_shard_plain(
                         *[[x.clone() for x in lv] for lv in t0], None, g_loc, lr, bc1, bc2,
                         scales, base, pre=pre), iters=3),
                     library=_library_ms(t0[0], [r for r, _ in per], [g for _, g in per],
                                         [b] * L, lrs),
                     m_sh=int(g_loc.shape[0]), m_real=m_real)
            if worst is None or t["alone"] > worst["alone"]:
                worst = t
            del tim
        del pre, plain_pre, loc0, spread
        torch.cuda.empty_cache()
    elems = L * b * D
    nbytes = 2 * 12 * elems + worst["m_sh"] * (4 + 4 + 4 * D)
    flops = 13 * elems + worst["m_real"] * D
    bound = 1e3 * max(nbytes / H100_BYTES_PER_S, flops / H100_F32_FLOPS)
    print(f"[kernels] K2 shard on a live prep (fused_adam_multi_shard, f32 and bf16 moments; "
          f"{n} shards of {b} rows x {L} levels, cells padded per step): csrc/entry_prep.cu's "
          f"prep = entry_prep_local's tiles and (row, entry) pairs, pads excluded, none dropped; "
          f"each shard vs plain on that prep max_abs_err {out:.3e} (f32: phase 2's tolerance "
          f"plus the sum-order spread; bf16 moments one-ulp ties; single-entry rows bit-equal); "
          f"fullest shard {worst['k']} ({worst['m_real']} entries in {worst['m_sh']} slots): "
          f"prep {worst['prep']:.4f} ms (sorted prep {worst['sorted_prep']:.4f}), wrapper "
          f"{worst['wrapper']:.4f} ms, kernel alone {worst['alone']:.4f} ms"
          + ("" if worst["parent"] is None else
             f" (the parent's {worst['parent']:.4f} ms, in turns)") + ", plain "
          f"{worst['plain']:.4f} ms, library (index_add_ + fused torch.optim.Adam over the "
          f"blocks) {worst['library']:.4f} ms, bound {bound:.4f} ms (bytes), "
          f"{bound / worst['alone']:.0%} of bound")
    return out, worst["library"]


def _incre_multi_rank(rank, world, port, backend, cfg, out_path):
    """One rank of a two-rank incremental CLI run (runs (h), (i)): launch
    counts zeroed just before the run and read just after; with replicated
    tables every frame's chunk is followed by a check that the ranks'
    tables, moments and decoders hold the same bits, and every importance
    sweep by one that their importance tables do.  Rank 0 saves its run
    path, the checks and every rank's launches."""
    import torch
    import torch.distributed as dist

    from shine_mapping_tpu_torch.cli import shine_incre
    from shine_mapping_tpu_torch.ops import adam_kernel as ak
    from shine_mapping_tpu_torch.parallel import mesh
    from shine_mapping_tpu_torch.train import trainer

    grp = _join_ranks(rank, world, port, backend)
    cfg.device = str(grp.device)
    checks = {"replicas": [], "importance": []}
    inner_train, inner_imp = trainer.train_chunk, shine_incre.cal_feature_importance

    def train(*a, **kw):
        params, opt, aux = inner_train(*a, **kw)
        if grp.table_sharding == "replicated":
            checks["replicas"].append(mesh.replicas_equal(grp, mesh.state_tensors(params, opt)))
        return params, opt, aux

    def imp(grid, *a, **kw):
        inner_imp(grid, *a, **kw)
        checks["importance"].append(mesh.replicas_equal(grp, grid.importance_weight))

    trainer.train_chunk, shine_incre.cal_feature_importance = train, imp
    if cfg.batch_windows:
        shine_incre.PRECOMPUTE_WORK_RATIO = 0.0
    ak.reset_launch_counts()  # this path starts here
    t0 = time.perf_counter()
    run_path, _, _ = shine_incre.run_shine_mapping_incremental(cfg=cfg, group=grp)
    counts = dict(ak.LAUNCHES)  # read right after the path
    wall = time.perf_counter() - t0
    per_rank = [None] * world
    dist.all_gather_object(per_rank, counts)
    if rank == 0:
        torch.save(dict(run_path=run_path, wall=wall, launches=per_rank, **checks), out_path)
    dist.barrier()
    dist.destroy_process_group()


def _incre_one_rank(run, world, out, gt_path, n_frames, rows=False):
    """The one-rank run of ``run``'s config at these frames (the two-rank
    runs' yardstick): (F-score, metrics records)."""
    from shine_mapping_tpu_torch.cli import shine_incre
    from shine_mapping_tpu_torch.config import SHINEConfig
    from shine_mapping_tpu_torch.eval.metrics import eval_mesh

    cfg, _ = incre_config(SHINEConfig, run, world, out, n_frames, DEVICE)
    ratio = shine_incre.PRECOMPUTE_WORK_RATIO
    if run[3]:
        shine_incre.PRECOMPUTE_WORK_RATIO = 0.0
    try:
        run_path, _, _ = shine_incre.run_shine_mapping_incremental(cfg=cfg)
    finally:
        shine_incre.PRECOMPUTE_WORK_RATIO = ratio
    m = eval_mesh(os.path.join(run_path, f"mesh/mesh_frame_{n_frames}.ply"), gt_path, **EVAL_KW)
    with open(os.path.join(run_path, "metrics.jsonl")) as f:
        return m["F-score (%)"], [json.loads(line) for line in f]


def phase_incre_multi_cli(n_frames=5, n_az=1024, n_el=64):
    """Runs (h) and (i): the incremental CLI over two ranks on phase 7's
    world (two gloo ranks on one card, or NCCL one rank a card), (h) run E's
    config (replicated tables, the reg on per-frame fused windows, bf16
    moments, K2), (i) run C's with ``table_sharding: rows`` (the reg folded
    by the rows' ranks, iid batches routed live, K2's row-sharded caller on
    a live prep).  Each against the one-rank run of its config over the
    same frames.  Returns the launches summed over both runs' ranks."""
    import tempfile

    import numpy as np
    import torch
    import torch.multiprocessing as mp

    from shine_mapping_tpu_torch.config import SHINEConfig
    from shine_mapping_tpu_torch.eval.metrics import eval_mesh
    from shine_mapping_tpu_torch.parallel import mesh

    backend = "nccl" if torch.cuda.device_count() >= 2 else "gloo"
    runs = (("h", "run E's config, replicated tables", INCRE_RUNS[2], {}),
            ("i", "run C's config, row-sharded tables (iid, live routing)", INCRE_RUNS[0],
             {"table_sharding": "rows"}))
    launches = {}
    with tempfile.TemporaryDirectory(prefix="smoke_incre_multi_") as tmp:
        world = os.path.join(tmp, "world")
        _, gt_path = write_synth_sequence(world, n_frames, n_az, n_el)
        for tag, what, run, extra in runs:
            cfg, line = incre_config(SHINEConfig, run, world, os.path.join(tmp, tag), n_frames,
                                     DEVICE)
            print(line.replace("[incre]", f"[incre-multi] ({tag})")
                  + (f"; tpu: {extra}" if extra else "") + "; 2 ranks")
            for k, v in extra.items():
                setattr(cfg, k, v)
            out = os.path.join(tmp, tag + ".pt")
            mp.start_processes(_incre_multi_rank, args=(2, mesh.free_port(), backend, cfg, out),
                               nprocs=2, start_method="spawn", join=True)
            got = torch.load(out, weights_only=False)
            key, per_step = run[4], run[5]
            if extra.get("table_sharding") == "rows":
                key, per_step = "fused_adam_multi_shard", 1  # and one live prep a step
            steps = n_frames * cfg.iters
            for c in got["launches"]:
                assert c[key] == steps * per_step, f"({tag}) {c[key]} {key} launches a rank"
                if key == "fused_adam_multi_shard":
                    assert c["entry_prep"] == steps, f"({tag}) {c['entry_prep']} preps a rank"
                others = {k: x for k, x in c.items() if k not in (key, "entry_prep") and x}
                assert not others, f"({tag}) other kernels launched: {others}"
                for k, x in c.items():
                    launches[k] = launches.get(k, 0) + x
            assert got["importance"] == [True] * n_frames, f"({tag}) the importance parted"
            if extra.get("table_sharding") != "rows":
                assert got["replicas"] == [True] * n_frames, f"({tag}) the replicas parted"
            with open(os.path.join(got["run_path"], "metrics.jsonl")) as f:
                recs = [json.loads(line) for line in f]
            assert len(recs) == n_frames and all(np.isfinite(r["loss/total_loss"]) for r in recs)
            assert all(r["loss/reg_loss"] > 0 for r in recs[1:]), f"({tag}) no reg after frame 0"
            m = eval_mesh(os.path.join(got["run_path"], f"mesh/mesh_frame_{n_frames}.ply"),
                          gt_path, **EVAL_KW)
            f1, recs1 = _incre_one_rank(run, world, os.path.join(tmp, tag + "1"), gt_path,
                                        n_frames)
            ms = float(np.median([(r["timing(s)/mapping"] - r["timing(s)/importance"])
                                  / cfg.iters for r in recs[1:]])) * 1e3
            ms1 = float(np.median([(r["timing(s)/mapping"] - r["timing(s)/importance"])
                                   / cfg.iters for r in recs1[1:]])) * 1e3
            med = {k: float(np.median([r[f"timing(s)/{k}"] for r in recs]))
                   for k in ("preprocess", "mapping", "importance")}
            gap = abs(m["F-score (%)"] - f1)
            print(f"[incre-multi] ({tag}) {what}, 2 ranks over {backend}: {n_frames} frames x "
                  f"{cfg.iters} steps, {got['launches'][0][key]} {key} launches a rank"
                  + (f" and {got['launches'][0]['entry_prep']} live preps"
                     if key == "fused_adam_multi_shard" else "")
                  + f"; run {got['wall']:.1f} s; per frame (median) preprocess "
                  f"{med['preprocess']:.3f} s, mapping {med['mapping']:.3f} s (training {ms:.3f} "
                  f"ms/step; one rank {ms1:.3f}), importance {med['importance']:.3f} s; reg_loss "
                  f"{recs[1]['loss/reg_loss']:.4g} -> {recs[-1]['loss/reg_loss']:.4g}; "
                  + ("replicas bit-identical after every frame; " if tag == "h" else "")
                  + f"importance bit-identical on both ranks after every sweep; eval_mesh "
                  f"F-score {m['F-score (%)']:.3f} %, Chamfer-L1 {m['Chamfer_L1 (m)']:.4f} m; "
                  f"the one-rank run {f1:.3f} % ({gap:.3f} points; bar 5)")
            assert gap < 5.0, f"({tag}) two ranks {gap:.3f} points from one rank"
    return launches


def phase_incre_multi(per_run=None):
    """Phase 10 ("incre-multi"): K2's row-sharded caller on a live prep,
    runs (f) and (g) (row-sharded tables on iid batches; ``per_run``: their
    launches where phase 9's spawn ran them), runs (h) and (i) (the
    incremental CLI over two ranks).  Returns (the live check's max error,
    the library ms of the row-sharded f32 row, the launches of the runs
    summed over their ranks)."""
    t0 = time.perf_counter()
    err, lib_ms = phase_live_shard_kernel()
    if per_run is None:
        per_run = phase_multi_train(ROWS_IID_RUNS)
    launches = _launches_of(per_run, ROWS_IID_RUNS)
    for k, x in phase_incre_multi_cli().items():
        launches[k] = launches.get(k, 0) + x
    print(f"[incre-multi] phase 10 took {time.perf_counter() - t0:.1f} s")
    return err, lib_ms, launches


# ----------------------------------------------------------------- phase 11

# the synthetic room (tests/test_torch_rgbd_converter.py) at NeuralRGBD's
# camera: 640 x 480, the green room's focal length
ROOM_FRAMES = 30
ROOM_CAMERA = dict(W=640, H=480, focal=554.2562584220408)
ROOM_INCRE_EVERY = 2  # run (l): frames 0, 2, ..., 8, a third of a turn
ROOM_INCRE_FRAMES = 5
# eval_mesh at the room's scale: 1 cm spacing, inliers within 2 cm, no crop
# to the ground truth's bounding box (the walls lie on it; the crop would
# cut the half of each wall's vertices a hair outside)
ROOM_EVAL_KW = dict(down_sample_res=0.01, threshold=0.02, truncation_acc=0.2,
                    truncation_com=0.2, mesh_sample_point=2_000_000, gt_bbx_mask_on=False)
ROOM_BARS = (0.01, 90.0)  # Chamfer-L1 < 1 cm, F-score at 2 cm > 90 %
SURFACE_ITERS = 2000  # run (k): rgbd_batch.yaml's 20,000 cut
MULTIHOST_ITERS = 200  # run (j): phase 9's [multi] cli run's 500 cut
MULTIHOST_CHECK_STEP = 100  # run (j)'s step whose K2 shard launches are checked
# F-score (%) of the last mesh of run (l)'s config and frames that the JAX
# package's incremental driver reaches on the CPU: the mean over
# setting.seed 42, 1 and 2 (95.902 / 96.225 / 95.702; JAX_PLATFORMS=cpu
# python3 scripts/jax_incre_reference.py --room --seeds 42,1,2); run (l) on
# the card must come within INCRE_FSCORE_GAP of it
JAX_ROOM_INCRE_FSCORE = 95.943
# a snapshot is non-blank: this many pixels off the background (the
# rasterizer draws a mesh's nearest 60,000 triangles, MapVisualizer.
# max_draw_triangles: sub-pixel at the default camera for a 1 cm mesh, so a
# room's mesh covers a small share of the image)
SNAPSHOT_INK = 100


def write_room(root, n_frames=ROOM_FRAMES):
    """The synthetic room's RGB-D sequence (``write_rgbd_room``: 16-bit
    millimetre depth PNGs, RGB PNGs, a focal file, 4x4 poses), converted by
    the port's ``python -m shine_mapping_tpu_torch.data.rgbd_converter``
    into ``root/kitti``; the exact ground truth of all frames and of run
    (l)'s frames as ``gt_all.ply`` / ``gt_incre.ply``.  Returns (the
    converted root, {name: gt path}, timings)."""
    from shine_mapping_tpu_torch.data import io

    rgbd = _load_tests_module("test_torch_rgbd_converter")
    t0 = time.perf_counter()
    paths = rgbd.write_rgbd_room(os.path.join(root, "raw"), n_frames, **ROOM_CAMERA)
    t1 = time.perf_counter()
    kitti = os.path.join(root, "kitti")
    subprocess.run([sys.executable, "-m", "shine_mapping_tpu_torch.data.rgbd_converter",
                    "--depth_img_folder", paths["depth"], "--rgb_img_folder", paths["rgb"],
                    "--intrinsic_file", paths["focal"], "--pose_file", paths["poses"],
                    "--output_root", kitti], check=True, capture_output=True, timeout=600,
                   cwd=os.path.dirname(os.path.abspath(__file__)))
    t2 = time.perf_counter()
    incre = list(range(0, ROOM_INCRE_EVERY * ROOM_INCRE_FRAMES, ROOM_INCRE_EVERY))
    gts = {}
    for name, frames in (("all", None), ("incre", incre)):
        gts[name] = os.path.join(root, f"gt_{name}.ply")
        io.write_ply(gts[name], io.PointCloud(points=rgbd.room_gt_points(
            n_frames, **ROOM_CAMERA, frames=frames)))
    return kitti, gts, (t1 - t0, t2 - t1)


def surface_config(cls, name, kitti, out, cut, device=None):
    """``config/rgbd/<name>.yaml`` as written, cut by ``cut`` (printed),
    with the converted room's data paths, the output root and
    ``o3d_vis_on``; ``cls``: either package's SHINEConfig.  Returns
    (config, the ``[surface] reduced:`` line)."""
    path = f"config/rgbd/{name}.yaml"
    cfg = cls().load(path)
    line = (f"[surface] reduced: {path}: " + ", ".join(f"{k} {getattr(cfg, k)} -> {v}"
                                                       for k, v in cut.items())
            + f"; the room's {ROOM_FRAMES} frames of {ROOM_CAMERA['W']} x {ROOM_CAMERA['H']} "
            "(NeuralRGBD's green room: 1,442); data paths and output_root: the converted room; "
            f"o3d_vis_on {cfg.o3d_vis_on} -> True")
    cfg.pc_path = os.path.join(kitti, "rgbd_ply")
    cfg.pose_path = os.path.join(kitti, "poses.txt")
    cfg.output_root, cfg.o3d_vis_on = out, True
    if device is not None:
        cfg.device = device
    for k, v in cut.items():
        setattr(cfg, k, v)
    return cfg, line


def surface_incre_config(cls, kitti, out, device=None):
    """Run (l)'s config: ``rgbd_incre_reg.yaml`` on 5 frames of the room
    (every 2nd of 30: each overlaps the last, so the reg holds every frame
    after the first), a mesh at the last."""
    cut = {"every_frame": ROOM_INCRE_EVERY,
           "end_frame": ROOM_INCRE_EVERY * (ROOM_INCRE_FRAMES - 1),
           "mesh_freq_frame": ROOM_INCRE_FRAMES}
    return surface_config(cls, "rgbd_incre_reg", kitti, out, cut, device)


def _snapshots(run_path, want):
    """The PNGs of ``run_path/vis``: ``want`` of them, each non-blank."""
    import numpy as np
    from PIL import Image

    d = os.path.join(run_path, "vis")
    names = sorted(os.listdir(d))
    assert len(names) == want, f"{len(names)} snapshots in {d}, want {want}"
    ink = []
    for n in names:
        img = np.asarray(Image.open(os.path.join(d, n)))
        ink.append(int((img != 255).any(axis=2).sum()))
        assert ink[-1] >= SNAPSHOT_INK, f"{n}: {ink[-1]} pixels drawn"
    return (f"{len(names)} snapshots in run_path/vis, {min(ink)}-{max(ink)} pixels drawn of "
            f"{img.shape[0] * img.shape[1]}")


def _room_score(label, mesh_path, gt_path):
    from shine_mapping_tpu_torch.eval.metrics import eval_mesh

    m = eval_mesh(mesh_path, gt_path, **ROOM_EVAL_KW)
    print(f"[surface] {label}: eval_mesh F-score {m['F-score (%)']:.3f} % at "
          f"{ROOM_EVAL_KW['threshold']} m, precision {m['Precision [Accuracy] (%)']:.3f} %, "
          f"recall {m['Recall [Completeness] (%)']:.3f} %, Chamfer-L1 "
          f"{m['Chamfer_L1 (m)']:.5f} m")
    return m


def _shard_step_check(ak, launch, kern, loc0, g_loc, lr, bc1, bc2, scales, base, kw):
    """One step of K2's row-sharded caller in the bf16 map mode, as a rank
    of run (j) launched it (``kern``: its blocks after the launch, ``loc0``
    before), held against the plain version on the same inputs with phase
    9's bf16-p checks: rows with at most one entry bit-equal to the plain
    step with the kernel's noise (p, m and v); on every used row p's
    rounding against the unrounded step (:func:`_check_sr`, with a
    same-seed and an other-seed launch) and the moments bit-equal but for
    one-ulp ties (:func:`_check_bf16_ties`); the rows past the used head
    (no entry, zero moments) and levels with none untouched.  The used head
    of a block ends at its last row with an entry or a nonzero moment.  The
    check's own launches are taken off the counts.  Returns its summary."""
    import torch

    saved = dict(ak.LAUNCHES)
    pre, seed = kw["pre"], kw["sr_seed"]
    args = (None, g_loc, lr, bc1, bc2, scales, base)
    ref = [[t.clone() for t in lv] for lv in loc0]
    ak.fused_adam_shard_plain(*ref, *args, **kw)
    exact = [[t.float() for t in loc0[0]], [t.clone() for t in loc0[1]],
             [t.clone() for t in loc0[2]]]
    ak.fused_adam_shard_plain(*exact, *args, **dict(kw, sr_seed=None))
    again = [[t.clone() for t in lv] for lv in loc0]
    other = [[t.clone() for t in lv] for lv in loc0]
    launch(*again, *args, **kw)
    launch(*other, *args, **dict(kw, sr_seed=seed + 1))
    torch.cuda.synchronize()
    for k in ak.LAUNCHES:  # only the path's own launch counts
        ak.LAUNCHES[k] = saved[k]
    sizes = [int(t.shape[0]) for t in loc0[0]]
    rows = pre.rows.reshape(-1).long()
    per_row = torch.bincount(rows[rows < sum(sizes)], minlength=sum(sizes)).split(sizes)
    used = []
    for l, n in enumerate(per_row):
        live = (n > 0) | (loc0[1][l].float() != 0).any(1) | (loc0[2][l].float() != 0).any(1)
        used.append(int(torch.nonzero(live).max()) + 1 if bool(live.any()) else 0)
        for t in range(3):
            a, c = kern[t][l].view(torch.int16), ref[t][l].view(torch.int16)
            diff = int((a[n <= 1] != c[n <= 1]).sum())
            assert diff == 0, f"(j) step: table {t} level {l}: {diff} single-row elements differ"
            if not used[-1]:
                assert torch.equal(a, loc0[t][l].view(torch.int16)), \
                    f"(j) step: unused level {l} changed"
    out = dict(blocks=sizes, used=used, entries=int(g_loc.shape[0]), max_abs_err=0.0)
    if any(used):
        (p_k, p_e, p_0, p_a, p_o), u = _levels_with(
            [kern[0], exact[0], loc0[0], again[0], other[0]], used)
        err, mean, sigma, worst = _check_sr(p_k, p_e, p_0, u, p_a, p_o)
        mv, u = _levels_with(kern[1:] + exact[1:] + loc0[1:], used)
        tie_err, ties = _check_bf16_ties(mv[0:2], mv[2:4], mv[4:6], u, moved_share=None)
        out.update(max_abs_err=max(err, tie_err), sr_mean_ulp=mean, sr_sigma=sigma,
                   sr_worst_bin=worst, tie_share=ties)
    return out


class _ShardStepHook:
    """``adam_kernel.fused_adam_shard`` for a rank of run (j): every call
    goes to the wrapper, and the ``at``-th (a step of the run) is then held
    against its plain version (:func:`_shard_step_check`; ``result``)."""

    def __init__(self, ak, at):
        self.ak, self.at, self.calls, self.result = ak, at, 0, None
        self.launch = ak.fused_adam_shard

    def __call__(self, ps, ms, vs, rows_loc, g_loc, lr, bc1, bc2, scales, base, **kw):
        self.calls += 1
        if self.calls != self.at:
            return self.launch(ps, ms, vs, rows_loc, g_loc, lr, bc1, bc2, scales, base, **kw)
        assert rows_loc is None and kw.get("sr_seed") is not None, "(j): not the bf16 map mode"
        loc0 = [[t.clone() for t in lv] for lv in (ps, ms, vs)]
        out = self.launch(ps, ms, vs, rows_loc, g_loc, lr, bc1, bc2, scales, base, **kw)
        kern = [[t.clone() for t in lv] for lv in (ps, ms, vs)]
        self.result = _shard_step_check(self.ak, self.launch, kern, loc0, g_loc.clone(), lr,
                                        bc1, bc2, scales, base, kw)
        return out


def _counted_batch(config_path, cfg, group=None):
    """One rank of run (j): the batch driver with this rank's launch counts
    zeroed just before it and written to ``cfg.output_root``'s sibling
    ``counts/`` just after, with the check of its step
    ``MULTIHOST_CHECK_STEP`` (:class:`_ShardStepHook`; the processes
    launched apart run their ranks through this function;
    :func:`_multihost_process`)."""
    from shine_mapping_tpu_torch.cli import shine_batch
    from shine_mapping_tpu_torch.ops import adam_kernel as ak

    hook = _ShardStepHook(ak, MULTIHOST_CHECK_STEP)
    ak.fused_adam_shard = hook
    ak.reset_launch_counts()
    try:
        out = shine_batch.run_shine_mapping_batch(config_path, cfg, group=group)
    finally:
        ak.fused_adam_shard = hook.launch
    counts = dict(ak.LAUNCHES)
    d = os.path.join(os.path.dirname(cfg.output_root), "counts")
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, f"rank{group.rank}.json"), "w") as f:
        json.dump({"launches": counts, "world": group.world, "run_path": out[0],
                   "device": str(group.device), "check": hook.result}, f)
    return out


def _multihost_config(world, out, **knobs):
    """Run (j)'s config: phase 9's ``[multi] cli`` config (row-sharded tables,
    the bf16 map mode) on phase 6's world, ``tpu.mesh_shape: 4``."""
    return _map_config(world, out, MULTIHOST_ITERS, mesh_shape=4, table_sharding="rows",
                       shard_ingest=True, feature_update="pallas", moments_bf16=True,
                       batch_windows=True, params_bf16=True, **knobs)


def _multihost_process(pid, port, world, out):
    """One of run (j)'s two processes, launched apart: the batch driver's
    entry point with ``tpu.num_processes: 2``, this ``process_id`` and the
    coordinator; its local ranks count their launches (the driver spawns
    ``run_shine_mapping_batch``, here :func:`_counted_batch`)."""
    from shine_mapping_tpu_torch.cli import shine_batch

    cfg = _multihost_config(world, out, num_processes=2, process_id=pid,
                            coordinator=f"localhost:{port}")
    run = shine_batch.run_shine_mapping_batch
    shine_batch.run_shine_mapping_batch = _counted_batch  # what the driver spawns
    run_path, grid, params = run(cfg=cfg)
    print(f"PROCESS_DONE {pid} {run_path} {grid is None and params is None}", flush=True)


def _fixed_sample_losses(cfg, ckpts):
    """The training loss at 65,536 fixed pool samples of the world (one
    process's data phase) at the driver's initial state and at each
    checkpoint's, on the card; and each checkpoint's largest |d p| from the
    first's."""
    import numpy as np
    import torch

    from shine_mapping_tpu_torch.cli.common import build_grid, pool_capacity_for
    from shine_mapping_tpu_torch.data.dataset import LiDARDataset
    from shine_mapping_tpu_torch.train import trainer
    from shine_mapping_tpu_torch.utils import checkpoint as ckpt

    ds = LiDARDataset(cfg, build_grid(cfg))
    ds.process_frames_pipelined(ds.frame_ids(), workers=4)
    grid = ds.grid
    s = trainer.TrainSettings.from_config(cfg, grid.levels,
                                          n_used=trainer.used_rows_for(grid, granularity=64))
    pool, n = trainer.pool_to_device(ds.pool, pool_capacity_for(len(ds.pool), 1 << 17),
                                     DEVICE, settings=s)
    k = min(65536, n)
    fixed = torch.arange(k, device=DEVICE) * n // k
    params = trainer.init_params(cfg, grid, torch.Generator(DEVICE).manual_seed(cfg.seed))
    params["features"] = [f.to(torch.bfloat16).float() for f in params["features"]]
    losses = [float(trainer.batch_loss(params, grid.tables, pool, fixed, s)["total_loss"])]
    ps = []
    for path in ckpts:
        skeleton = trainer.init_params(cfg, build_grid(cfg))
        g, p, _, _ = ckpt.load_checkpoint(path, skeleton, device=DEVICE)
        losses.append(float(trainer.batch_loss(p, g.tables, pool, fixed, s)["total_loss"]))
        ps.append(p["features"])
    err = [max(float((a - b).abs().max()) for a, b in zip(ps[0], q)) for q in ps[1:]]
    assert np.all(np.isfinite(losses)), losses
    return losses, err


def phase_surface_multihost(n_frames=20):
    """Run (j): two processes launched apart form 4 ranks through the
    config's knobs (module doc).  Returns (the ranks' launches summed, the
    largest error of the ranks' checked K2 shard step against its plain
    version)."""
    import signal
    import tempfile

    import numpy as np
    import torch

    from shine_mapping_tpu_torch.cli.shine_batch import run_shine_mapping_batch
    from shine_mapping_tpu_torch.parallel.mesh import free_port

    n_cards = torch.cuda.device_count()
    with tempfile.TemporaryDirectory(prefix="smoke_surface_j_") as tmp:
        world = os.path.join(tmp, "world")
        _, gt_path = write_synth_sequence(world, n_frames)
        if MAP_B not in MAP_SCORES:  # phase 6 did not run: its run B here
            cfg_b = _map_config(world, os.path.join(tmp, "b"), 500, feature_update="pallas",
                                moments_bf16=True, batch_windows=True, params_bf16=True)
            _map_run(MAP_B, cfg_b, gt_path, "fused_adam_multi_bf16p", 1, 1)
        print(f"[surface] (j) reduced: iters 500 -> {MULTIHOST_ITERS} (phase 9's [multi] cli "
              "run; vis_freq_iters and save_freq_iters with it)")
        two = os.path.join(tmp, "two", "runs")
        port = free_port()
        procs = []
        t0 = time.perf_counter()
        for pid in range(2):
            env = dict(os.environ)
            if n_cards >= 4:  # two cards a process, NCCL one rank a card
                env["CUDA_VISIBLE_DEVICES"] = f"{2 * pid},{2 * pid + 1}"
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--multihost-process", str(pid),
                 str(port), world, two], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                env=env, start_new_session=True))
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=900)[0].decode())
        finally:
            for p in procs:  # a process and the ranks it spawned, by group id
                if p.poll() is None:
                    os.killpg(p.pid, signal.SIGKILL)
                    p.wait()
        wall = time.perf_counter() - t0
        for pid, (p, text) in enumerate(zip(procs, outs)):
            assert p.returncode == 0, f"(j) process {pid} failed:\n{text[-4000:]}"
        runs = os.listdir(two)
        assert len(runs) == 1, f"(j) run directories {runs}: rank 0's alone expected"
        run_path = os.path.join(two, runs[0])
        for pid, text in enumerate(outs):
            line = [ln for ln in text.splitlines() if ln.startswith("PROCESS_DONE")]
            assert line and line[-1].split()[1:] == [str(pid), run_path, "True"], \
                f"(j) process {pid}: {line}"
        backend = "nccl" if n_cards >= 4 else "gloo"
        assert f"4 ranks over {backend}" in outs[0], outs[0][-4000:]
        counts = []
        for r in range(4):
            with open(os.path.join(tmp, "two", "counts", f"rank{r}.json")) as f:
                counts.append(json.load(f))
        key = "fused_adam_multi_shard_bf16p"
        per = [c["launches"][key] for c in counts]
        assert all(c["world"] == 4 and c["run_path"] == run_path for c in counts), counts
        assert per == [MULTIHOST_ITERS] * 4, f"(j) {key} launches per rank {per}"
        checks = [c["check"] for c in counts]
        assert all(ch is not None for ch in checks), f"(j) step checks {checks}"
        shard_err = max(ch["max_abs_err"] for ch in checks)
        print(f"[kernels] K2 shard {key} at run (j)'s row blocks: step "
              f"{MULTIHOST_CHECK_STEP} of each rank (blocks {checks[0]['blocks']} rows, used "
              f"heads by rank {[ch['used'] for ch in checks]}, entries by rank "
              f"{[ch['entries'] for ch in checks]}) against its plain version with phase 9's "
              "bf16-p checks (single-entry rows bit-equal to the plain step with the kernel's "
              "noise; p's rounding against the unrounded step, the same seed the same bits, "
              "another seed not; moments one-ulp ties): max_abs_err by rank "
              + ", ".join(f"{ch['max_abs_err']:.3e}" for ch in checks) + "; SR mean error "
              "by rank " + ", ".join(f"{ch.get('sr_mean_ulp', 0):.2e} ulp (sigma "
              f"{ch.get('sr_sigma', 0):.1e})" for ch in checks) + "; moment tie share by rank "
              + ", ".join(f"{ch.get('tie_share', 0):.2e}" for ch in checks))
        others = {k: n for c in counts for k, n in c["launches"].items()
                  if k not in (key, "entry_prep") and n}
        assert not others, f"(j) other kernels launched: {others}"
        with open(os.path.join(run_path, "metrics.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        ms = [r["timing(s)/per_iter"] * 1e3 for r in recs]
        from shine_mapping_tpu_torch.eval.metrics import eval_mesh

        m = eval_mesh(os.path.join(run_path, f"mesh/mesh_iter_{MULTIHOST_ITERS}.ply"), gt_path,
                      **EVAL_KW)
        gap = abs(m["F-score (%)"] - MAP_SCORES[MAP_B])
        print(f"[surface] (j) two processes launched apart (tpu.num_processes 2, mesh_shape 4, "
              f"their own process_id, coordinator localhost:{port}"
              + (", CUDA_VISIBLE_DEVICES 0,1 / 2,3" if n_cards >= 4 else ", one card") +
              f"): 4 ranks over {backend} (devices {[c['device'] for c in counts]}), "
              f"{MULTIHOST_ITERS} steps at {float(np.median(ms[1:] or ms)):.3f} ms/step (rank "
              f"0's metrics.jsonl), data phase {recs[-1]['phase(s)/data']:.2f} s (sharded), "
              f"both processes {wall:.1f} s; {key} launches per rank {per}, entry_prep "
              f"{[c['launches']['entry_prep'] for c in counts]}; eval_mesh F-score "
              f"{m['F-score (%)']:.3f} %, Chamfer-L1 {m['Chamfer_L1 (m)']:.4f} m (bars: < "
              f"{MAP_BARS[0]} m, > {MAP_BARS[1]} %), {gap:.3f} points from phase 6's run B "
              f"({MAP_SCORES[MAP_B]:.3f} %; bar 5); one run directory, rank 0's, returned by "
              "both processes")
        assert m["Chamfer_L1 (m)"] < MAP_BARS[0] and m["F-score (%)"] > MAP_BARS[1], m
        assert gap <= 5.0, f"(j) {gap:.3f} points from run B"
        # the same config spawned by one process (mesh_shape 4)
        cfg1 = _multihost_config(world, os.path.join(tmp, "one"))
        t0 = time.perf_counter()
        one_path, _, _ = run_shine_mapping_batch(cfg=cfg1)
        t_one = time.perf_counter() - t0
        losses, err = _fixed_sample_losses(cfg1, [
            os.path.join(one_path, "model", "model_final.npz"),
            os.path.join(run_path, "model", "model_final.npz")])
        before, one, two_l = losses
        drop = before - one
        print(f"[surface] (j) against one process spawning 4 ranks ({t_one:.1f} s): "
              f"fixed-sample loss {before:.6f} -> {one:.6f} (one process) / {two_l:.6f} (two "
              f"processes), within {abs(two_l - one) / drop:.4f} of the drop (phase 9's "
              f"row-shard tolerance: 0.05); final tables max |d p| {err[0]:.3e}")
        assert one < before and abs(two_l - one) <= 0.05 * drop, \
            f"(j) fixed-sample loss {two_l} vs one process {one} (from {before})"
    launches = {}
    for c in counts:
        for k, n in c["launches"].items():
            launches[k] = launches.get(k, 0) + n
    return launches, shard_err


def _surface_batch(kitti, out, gt_path):
    """Run (k): the batch CLI with rgbd_batch.yaml at its full width on the
    converted room.  Returns (launch counts, grid)."""
    import numpy as np

    from shine_mapping_tpu_torch.cli.shine_batch import run_shine_mapping_batch
    from shine_mapping_tpu_torch.config import SHINEConfig
    from shine_mapping_tpu_torch.ops import adam_kernel as ak
    from shine_mapping_tpu_torch.utils import profiling

    iters = SURFACE_ITERS
    cut = {"iters": iters, "vis_freq_iters": iters // 2, "save_freq_iters": iters,
           "every_frame": 1}
    cfg, line = surface_config(SHINEConfig, "rgbd_batch", kitti, out, cut, DEVICE)
    print(line)
    print(f"[surface] (k) rgbd_batch: {cfg.tree_level_feat} levels, D {cfg.feature_dim}, leaf "
          f"{cfg.leaf_vox_size} m, world level {cfg.tree_level_world}, bs {cfg.bs}, mlp "
          f"{cfg.geo_mlp_level}x{cfg.geo_mlp_hidden_dim}, {cfg.main_loss_type}, eikonal "
          f"{cfg.ekional_loss_on}, octree meshing at {cfg.mc_res_m} m (query level "
          f"{cfg.mc_query_level}), calib_path {cfg.calib_path!r} (identity Tr), device "
          f"{cfg.device}")
    assert (cfg.tree_level_feat, cfg.leaf_vox_size, cfg.tree_level_world, cfg.bs,
            cfg.mc_res_m, cfg.mc_with_octree) == (4, 0.02, 12, 4096, 0.01, True)
    levels = cfg.tree_level_feat
    ak.reset_launch_counts()  # this path starts here
    t0 = time.perf_counter()
    run_path, grid, params = run_shine_mapping_batch(cfg=cfg)
    counts = dict(ak.LAUNCHES)  # read right after the path
    wall = time.perf_counter() - t0
    assert counts["fused_adam"] == iters and counts["entry_prep"] == iters, \
        f"(k) launches {counts}: want one fused_adam and one entry_prep a step"
    assert ak.LEVEL_STEPS["fused_adam"] == levels * iters, \
        f"(k) {ak.LEVEL_STEPS['fused_adam']} level steps: want {levels} a step"
    others = {k: n for k, n in counts.items() if k not in ("fused_adam", "entry_prep") and n}
    assert not others, f"(k) other kernels launched: {others}"
    with open(os.path.join(run_path, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    losses = [r["loss/total_loss"] for r in recs]
    assert np.all(np.isfinite(losses)) and losses[-1] < losses[0], f"(k) losses {losses}"
    ms = [r["timing(s)/per_iter"] * 1e3 for r in recs]
    meshes = [r for r in recs if "mesh/vertices" in r]
    peaks = profiling.last_hbm_monitor.samples
    print(f"[surface] (k) run: data phase {recs[-1]['phase(s)/data']:.2f} s, pool "
          f"{int(recs[-1]['pool_samples'])} samples, tables {[f.shape[0] for f in grid.features]} "
          f"rows, corners {grid.corner_counts}; {iters} steps at "
          f"{float(np.median(ms[1:] or ms)):.3f} ms/step (median over the {len(ms) - 1} chunks "
          f"after the first; first {ms[0]:.3f}), fused_adam {counts['fused_adam']} launches "
          f"(one a step over the {levels} levels), entry_prep {counts['entry_prep']}; loss "
          f"{losses[0]:.4f} -> "
          f"{losses[-1]:.4f}; peak device memory training {peaks['train'] / 2**30:.3f} GiB, "
          f"meshing {peaks['mesh'] / 2**30:.3f} GiB; run {wall:.1f} s")
    for r in meshes:
        print(f"[surface] (k) mesh at iter {r['iter']}: {int(r['mesh/vertices'])} vertices, "
              f"{int(r['mesh/triangles'])} triangles; meshing "
              + ", ".join(f"{k} {r['mesh(s)/' + k]:.3f} s"
                          for k in ("query", "readback", "marching", "finalize")))
    print(f"[surface] (k) {_snapshots(run_path, len(meshes))} (one a mesh)")
    m = _room_score("(k) rgbd_batch", os.path.join(run_path, f"mesh/mesh_iter_{iters}.ply"),
                    gt_path)
    print(f"[surface] (k) bars: Chamfer-L1 < {ROOM_BARS[0]} m, F-score > {ROOM_BARS[1]} %")
    assert m["Chamfer_L1 (m)"] < ROOM_BARS[0] and m["F-score (%)"] > ROOM_BARS[1], \
        f"(k) map quality under the bars: {m}"
    return counts, grid, cfg


def _surface_incre(kitti, out, gt_path):
    """Run (l): the incremental CLI with rgbd_incre_reg.yaml on 5 frames of
    the room.  Returns (launch counts, the final grid, config)."""
    import numpy as np

    from shine_mapping_tpu_torch.cli.shine_incre import run_shine_mapping_incremental
    from shine_mapping_tpu_torch.config import SHINEConfig
    from shine_mapping_tpu_torch.ops import adam_kernel as ak

    cfg, line = surface_incre_config(SHINEConfig, kitti, out, DEVICE)
    print(line)
    levels = cfg.tree_level_feat
    ak.reset_launch_counts()
    t0 = time.perf_counter()
    run_path, grid, _ = run_shine_mapping_incremental(cfg=cfg)
    counts = dict(ak.LAUNCHES)
    wall = time.perf_counter() - t0
    steps = ROOM_INCRE_FRAMES * cfg.iters
    assert counts["fused_adam"] == steps and counts["entry_prep"] == steps, \
        f"(l) launches {counts}: want one fused_adam and one entry_prep a step"
    assert ak.LEVEL_STEPS["fused_adam"] == levels * steps, \
        f"(l) {ak.LEVEL_STEPS['fused_adam']} level steps: want {levels} a step"
    others = {k: n for k, n in counts.items() if k not in ("fused_adam", "entry_prep") and n}
    assert not others, f"(l) other kernels launched: {others}"
    with open(os.path.join(run_path, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    assert len(recs) == ROOM_INCRE_FRAMES
    assert all(np.isfinite(r["loss/total_loss"]) for r in recs)
    reg = [r["loss/reg_loss"] for r in recs]
    assert reg[0] == 0 and all(x > 0 for x in reg[1:]), f"(l) reg_loss by frame {reg}"
    med = {k: float(np.median([r[f"timing(s)/{k}"] for r in recs]))
           for k in ("preprocess", "mapping", "importance", "reconstruct")}
    print(f"[surface] (l) run: {ROOM_INCRE_FRAMES} frames, {cfg.iters} steps a frame, pool "
          f"{recs[-1]['pool_samples']} samples at the last, fused_adam {counts['fused_adam']} "
          f"launches (one a step over the {levels} levels), entry_prep {counts['entry_prep']}; "
          f"reg_loss by frame "
          f"{[f'{x:.3g}' for x in reg]}; per-frame medians " +
          ", ".join(f"{k} {v:.3f} s" for k, v in med.items()) + f"; run {wall:.1f} s; "
          f"{_snapshots(run_path, ROOM_INCRE_FRAMES)} (one a frame)")
    last = ROOM_INCRE_EVERY * (ROOM_INCRE_FRAMES - 1) + 1
    m = _room_score("(l) rgbd_incre_reg", os.path.join(run_path, f"mesh/mesh_frame_{last}.ply"),
                    gt_path)
    gap = abs(m["F-score (%)"] - JAX_ROOM_INCRE_FSCORE)
    print(f"[surface] (l) F-score {gap:.3f} points from the JAX driver's on the CPU "
          f"({JAX_ROOM_INCRE_FSCORE:.3f} %; bar {INCRE_FSCORE_GAP})")
    assert gap <= INCRE_FSCORE_GAP, f"(l) {gap:.3f} points from JAX"
    return counts, grid, cfg


def phase_surface_kernel(where, sizes, n_used, M, one_row=None):
    """[kernels] K1's per-level step as the trainer's per-level branch issues
    it (``fused_adam_levels``: one entry prep and one launch over the
    levels, each level's lr) at ``where``'s tables (run (k)'s or (l)'s
    final tables at 4 levels; phase 2's hot case): ``sizes`` rows,
    ``n_used`` used heads, M entries a level (bs x 8 corners; level
    ``one_row``'s all on one row), against the per-level plain steps with
    phase 2's checks plus the sum-order spread; ms of the step's call, with
    a precomputed prep, the kernel alone (CUDA-graph replay), the parent's
    per-level launches alone in turns (where its source was copied in),
    plain, library and bound.  Returns the JSON entry."""
    import numpy as np
    import torch

    from shine_mapping_tpu_torch.ops import adam_kernel as ak

    dev, D, L = torch.device(DEVICE), 8, len(sizes)
    lr, bc1, bc2 = 0.01, 1 - 0.9 ** 5, 1 - 0.99 ** 5
    scales = [1.0] * L
    lrs = [lr * x for x in scales]
    rng = np.random.default_rng(11)
    tabs0, rows_l, g_l = _kernel_inputs(rng, sizes, n_used, M, D, dev)
    if one_row is not None:  # its entries all on one row, the trashbin's kept
        r = rows_l[one_row]
        rows_l[one_row] = torch.where(r == sizes[one_row] - 1, r, n_used[one_row] // 2)
    single = _single_rows(rows_l, sizes, n_used)
    kern = [[t.clone() for t in lv] for lv in tabs0]
    ref = [[t.clone() for t in lv] for lv in tabs0]
    ak.fused_adam_levels(*kern, rows_l, g_l, lr, bc1, bc2, scales, n_used)

    def plain():
        for lv in range(L):
            ak.fused_adam_plain(ref[0][lv], ref[1][lv], ref[2][lv], rows_l[lv], g_l[lv],
                                lrs[lv], bc1, bc2, n_used[lv])

    plain()
    torch.cuda.synchronize()
    spreads = [_sum_order_spread([t[lv] for t in tabs0], rows_l[lv], g_l[lv], lrs[lv], bc1, bc2,
                                 n_used[lv]) for lv in range(L)]
    spread = [[sp[t][0] for sp in spreads] for t in range(3)]
    err = _check_f32(kern, ref, tabs0, n_used, single=single, spread=spread)
    share = max(_share_used(kern[t][lv], ref[t][lv],
                            1e-5 * ref[t][lv].abs() + spread[t][lv] + min(
                                1e-6, 1e-5 * float(tabs0[t][lv][:n_used[lv]].abs().max())))
                for t in range(3) for lv in range(L))
    pre = ak.entry_prep(rows_l, sizes, n_used, D)
    n_split = int(pre.n_split)
    assert one_row is None or n_split > 0, f"{where}: no tile was split"

    def call(given=None):
        ak.fused_adam_levels(*kern, rows_l, g_l, lr, bc1, bc2, scales, n_used, pre=given)

    ent_off = [lv * M for lv in range(L)]
    offs = [sum(sizes[:lv]) for lv in range(L)]

    def alone():
        ak._launch("f32", *kern, g_l, ent_off, pre, n_used, offs, lrs, 0.9, 0.99, bc1, bc2,
                   1e-15)

    t_call, t_pre = cuda_ms(call), cuda_ms(lambda: call(pre))
    parent, t_parent = _parent_lib(), None
    if parent is not None:
        t_parent, t_alone = _in_turns(
            lambda: _launch_parent(parent, "f32", *kern, g_l, ent_off, pre, n_used, offs, lrs,
                                   0.9, 0.99, bc1, bc2, 1e-15), alone, graph_ms)
    else:
        t_alone = graph_ms(alone)
    t_plain = cuda_ms(plain, iters=5)
    t_lib = _library_ms(tabs0[0], rows_l, g_l, n_used, lrs)
    bound, by = _bound_ms(n_used, L * M, D)
    par = ("" if t_parent is None else
           f"the parent kernel alone on the same prep {t_parent:.4f} ms (in turns, "
           f"{t_parent / t_alone:.2f}x), ")
    hot = "" if one_row is None else f", level {one_row}'s entries on one row"
    print(f"[kernels] K1 fused_adam_levels at {L} levels ({where}: {list(sizes)} rows, used "
          f"{list(n_used)}, M {M} a level{hot}; work list {n_split} extra items of "
          f"{pre.chunk} entries): max_abs_err {err:.3e} (phase 2's tolerance plus the sum-order "
          f"spread, at most {share:.2f} of it used), bit-equal on single-entry rows; the step's "
          f"call (one prep + one launch) {t_call:.4f} ms, with pre {t_pre:.4f} ms, kernel "
          f"alone {t_alone:.4f} ms, {par}plain {t_plain:.4f} ms, library {t_lib:.4f} ms "
          f"(index_add_ + fused torch.optim.Adam; the call {t_lib / t_call:.2f}x faster), bound "
          f"{bound:.4f} ms ({by}), {bound / t_alone:.0%} of bound")
    row = dict(name="fused_adam", route="cuda", source=SOURCE, replaces=K1_TPU,
               variant=f"f32, {L} levels in one launch, {where}", max_abs_err=err,
               ms=t_call, ms_with_pre=t_pre, kernel_only_ms=t_alone, parent_kernel_ms=t_parent,
               plain_ms=t_plain, bound_ms=bound, bound_by=by, library_ms=t_lib)
    del tabs0, kern, ref, pre
    torch.cuda.empty_cache()
    return row


def phase_surface():
    """Phase 11 ("surface"): run (j), processes launched apart; runs (k)
    and (l), RGB-D mapping of the synthetic room; K1 at 4 levels against
    its plain version at each run's final tables (module doc).  Returns
    (K1's 4-level JSON entries of (k) and (l), each with its run's
    launches; run (j)'s launches and its K2 shard step's error)."""
    import tempfile

    from shine_mapping_tpu_torch.train import trainer

    t0 = time.perf_counter()
    print(f"[surface] nvidia-smi: {nvidia_smi()}")
    multihost = phase_surface_multihost()
    t_j = time.perf_counter() - t0
    with tempfile.TemporaryDirectory(prefix="smoke_surface_") as tmp:
        kitti, gts, (t_raw, t_conv) = write_room(tmp)
        print(f"[surface] room: {ROOM_FRAMES} frames of {ROOM_CAMERA['W']} x "
              f"{ROOM_CAMERA['H']} (16-bit mm depth, RGB, focal {ROOM_CAMERA['focal']:.3f}) "
              f"written in {t_raw:.1f} s, converted by python -m "
              f"shine_mapping_tpu_torch.data.rgbd_converter in {t_conv:.1f} s; exact ground "
              "truth of all frames and of run (l)'s")
        shapes = {}
        for run, go in (("(k)", lambda: _surface_batch(kitti, os.path.join(tmp, "k"),
                                                       gts["all"])),
                        ("(l)", lambda: _surface_incre(kitti, os.path.join(tmp, "l"),
                                                       gts["incre"]))):
            counts, grid, cfg = go()
            shapes[run] = ([f.shape[0] for f in grid.features],
                           list(trainer.used_rows_for(grid, granularity=64)), cfg.bs * 8,
                           counts["fused_adam"])
            del grid
    rows = []
    for run, (sizes, n_used, M, launches) in shapes.items():
        rows.append(phase_surface_kernel(f"run {run}'s tables", sizes, n_used, M))
        rows[-1]["launches"] = launches
    print(f"[surface] phase 11 took {time.perf_counter() - t0:.1f} s ((j) {t_j:.1f} s)")
    return rows, multihost


# ----------------------------------------------------------------- main


# phases that run alone with ``--only`` (a check while developing; the
# smoke itself is the run with no arguments)
ALONE = {"kernels": lambda: phase_kernels(),
         "agreement": lambda: (phase_agreement(), phase_agreement_options()),
         "map": lambda: phase_map(), "incre": lambda: phase_incre(),
         "city": lambda: phase_city(), "multi": lambda: phase_multi(),
         "incre-multi": lambda: phase_incre_multi(), "surface": lambda: phase_surface(),
         "launch": lambda: phase_surface_multihost()}  # phase 11's (j) alone


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 2
    import shine_mapping_tpu_torch  # noqa: F401  (fails outside a checkout)
    from shine_mapping_tpu_torch.config import SHINEConfig

    if len(sys.argv) == 6 and sys.argv[1] == "--multihost-process":  # phase 11's (j)
        _multihost_process(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
        return 0
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
    # phase 10's runs (f) and (g) train in phase 9's spawn, on its bench world
    shard_rows, multi_launches, per_run = phase_multi(MULTI_RUNS + ROWS_IID_RUNS)
    _, shard_lib_ms, live_launches = phase_incre_multi(per_run)
    surface_rows, (multihost_launches, multihost_err) = phase_surface()
    for k in kernels:  # K1/K2: counted over the training runs and the CLI runs
        k["launches"] = (launches[k["name"]] + map_launches.get(k["name"], 0)
                         + incre_launches.get(k["name"], 0) + city_launches.get(k["name"], 0)
                         + multi_launches.get(k["name"], 0) + live_launches.get(k["name"], 0))
    for r in shard_rows:  # K2's row-sharded caller: counted over phases 9, 10 and 11's runs
        r["launches"] += live_launches.get(r["name"], 0) + multihost_launches.get(r["name"], 0)
        if r["variant"] == "f32":
            r["library_ms"] = shard_lib_ms
        if r["variant"] == "bf16p":  # also checked at run (j)'s row blocks
            r["max_abs_err_run_j"] = multihost_err
            r["max_abs_err"] = max(r["max_abs_err"], multihost_err)
    kernels += shard_rows
    kernels += surface_rows  # K1 at 4 levels: each counted over its RGB-D run
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
