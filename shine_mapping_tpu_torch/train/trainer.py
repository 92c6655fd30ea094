"""Training loop: sample batch -> query grid -> MLP -> losses -> Adam.

Port of the main path of ``shine_mapping_tpu/train/trainer.py``:
``train_chunk`` with ``feature_update`` ``fused`` or ``pallas``, which is
``body_fused`` (trainer.py:1106) and, with fused epoch windows,
``body_winx`` (:1391) of the JAX package.  One step:

1. take ``bs`` pool indices — iid draws, or epoch window ``(start_iter + t)
   % W`` (:func:`precompute_batch_windows`) — and gather the batch;
2. per level, the 8 corner rows of the containing node: a hash lookup
   (``hashgrid.lookup_level``), or a gather from lookups resolved once per
   pool (:func:`precompute_pool_lookups`); misses -> the trashbin row; then
   gather the rows ``G_i`` (widened to float32 from bf16 tables);
3. interpolate and decode (``_feat_from_rows``, ``decoder.sdf``), take the
   loss (``_compute_loss_sparse``; the eikonal term differentiates the field
   w.r.t. the points, so the backward is second order);
4. Adam on the decoders (``optimizer.adam_update``);
5. the dense Adam step on the feature tables through the fused kernel
   (``ops/adam_kernel.py``), fed with the gathered rows' gradients: one
   launch per level (K1) or one over all levels (K2), with the row prep of
   a window precomputed.

JAX runs a chunk as one jitted ``lax.scan``; here it is a Python loop of
eager torch ops that update the parameters and the optimizer state in
place.  Both feature-update modes run the same reference dense Adam: on the
card through the CUDA kernel, on the CPU through its plain twin.
``fuse_update_levels`` picks the kernel's multi-level entry point (one
launch per step over all levels' tables) over the per-level one on iid
batches; with windows the window layout picks it.

The bf16 map mode (the JAX package's production configuration:
``tpu: {feature_update: pallas, moments_bf16: true, batch_windows: true,
params_bf16: true}``) is pool lookups + fused windows + bf16 moments
(``optimizer.init_opt_state(moments_bf16=True)``) + bf16 tables
(``HashGridHost.cast_features``), whose update writes the parameters back
with stochastic rounding seeded by the step's iteration.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.decoder import Decoder
from ..ops import adam_kernel
from ..ops.adam_kernel import EntryPrep
from ..ops.hashgrid import LevelTable, lookup_level
from ..ops.interp import corner_weights
from . import losses
from .optimizer import (
    FEATURES,
    OptState,
    adam_update,
    bias_corrections,
    dense_params,
    lr_at_step,
    make_group_trees,
)


@dataclasses.dataclass(frozen=True)
class TrainSettings:
    """Training configuration (the JAX package's fields and defaults)."""

    bs: int
    levels: Tuple[int, ...]
    poly_int_on: bool
    main_loss_type: str  # sdf_bce | sdf_l1 | sdf_l2 | dr | dr_neus
    loss_reduction: str
    loss_weight_on: bool
    sigma_sigmoid: float  # scaled: logistic_gaussian_ratio*sigma_sigmoid_m*scale
    scale: float
    ekional_loss_on: bool = False
    weight_e: float = 0.1
    normal_loss_on: bool = False
    weight_n: float = 0.01
    consistency_loss_on: bool = False
    weight_c: float = 1.0
    consistency_count: int = 1000
    consistency_range: float = 0.1
    proj_correction_on: bool = False
    semantic_on: bool = False
    weight_s: float = 1.0
    sem_label_decimation: int = 1
    continual_reg_on: bool = False
    lambda_forget: float = 1e5
    ray_loss: bool = False
    ray_sample_count: int = 7
    time_conditioned: bool = False
    # optimizer
    opt_adam: bool = True
    lr: float = 1e-3
    weight_decay: float = 0.0
    adam_eps: float = 1e-15
    lr_level_reduce_ratio: float = 1.0
    lr_iters_reduce_ratio: float = 0.1
    lr_decay_step: Tuple[int, ...] = (10000, 50000, 100000)
    # decoder freezing (incremental mode, shine_incre.py:93-97)
    freeze_decoder: bool = False
    # "fused" | "pallas": both run the kernel's dense Adam on the tables
    feature_update: str = "fused"
    # one kernel launch over all levels instead of one per level
    fuse_update_levels: bool = False
    # sort each batch's sample indices (order-invariant loss)
    sort_batch: bool = False
    # per-level used-corner heads (used_rows_for); None = whole tables
    n_used: Optional[Tuple[int, ...]] = None

    @classmethod
    def from_config(cls, cfg, levels: Tuple[int, ...], **overrides) -> "TrainSettings":
        kw = dict(
            bs=cfg.bs,
            levels=tuple(levels),
            poly_int_on=cfg.poly_int_on,
            main_loss_type=cfg.main_loss_type,
            loss_reduction=cfg.loss_reduction,
            loss_weight_on=cfg.loss_weight_on,
            sigma_sigmoid=cfg.logistic_gaussian_ratio * cfg.sigma_sigmoid_m * cfg.scale,
            scale=cfg.scale,
            ekional_loss_on=cfg.ekional_loss_on,
            weight_e=cfg.weight_e,
            normal_loss_on=cfg.normal_loss_on,
            weight_n=cfg.weight_n,
            consistency_loss_on=cfg.consistency_loss_on,
            weight_c=cfg.weight_c,
            consistency_count=cfg.consistency_count,
            consistency_range=cfg.consistency_range,
            proj_correction_on=cfg.proj_correction_on,
            semantic_on=cfg.semantic_on,
            weight_s=cfg.weight_s,
            sem_label_decimation=cfg.sem_label_decimation,
            continual_reg_on=False,
            lambda_forget=cfg.lambda_forget,
            ray_loss=cfg.ray_loss,
            ray_sample_count=cfg.surface_sample_n + cfg.free_sample_n + cfg.clearance_sample_n,
            time_conditioned=cfg.time_conditioned,
            opt_adam=cfg.opt_adam,
            lr=cfg.lr,
            weight_decay=cfg.weight_decay,
            adam_eps=cfg.adam_eps,
            lr_level_reduce_ratio=cfg.lr_level_reduce_ratio,
            lr_iters_reduce_ratio=cfg.lr_iters_reduce_ratio,
            lr_decay_step=tuple(cfg.lr_decay_step),
            feature_update=getattr(cfg, "feature_update", "fused"),
            fuse_update_levels=getattr(cfg, "fuse_update_levels", False),
            sort_batch=getattr(cfg, "sort_batch", False),
        )
        kw.update(overrides)
        return cls(**kw)


def used_rows_for(grid, granularity: int = 16) -> Tuple[int, ...]:
    """Per-level used-corner heads for TrainSettings.n_used (the update
    skips each table's capacity headroom — adam_kernel.used_rows_hint)."""
    return adam_kernel.used_rows_hint(
        [hl.n_corners for hl in grid.host_levels],
        [f.shape[0] for f in grid.features],
        granularity,
    )


def resolve_feature_update(settings: TrainSettings, fused_windows: bool = False) -> str:
    """The feature update ``train_chunk`` runs for these settings: the JAX
    package's ``_resolve_mode`` (trainer.py:650).  ``"pallas"`` is the kernel
    update the bf16 modes and the windows need (``"fused"`` runs the same
    kernel in the port, but the JAX package's gates name ``"pallas"``, and
    the port raises where they do).  ``fused_windows``: fused epoch windows
    will be supplied, the one layout on which the JAX package keeps the
    kernel under continual-learning reg.  Unlike the JAX package, nothing
    demotes a feature dim that does not pack into 128 lanes: the card's
    kernel takes any D."""
    s = settings
    mode = s.feature_update if s.opt_adam else "dense"
    if mode == "sparse" and s.consistency_loss_on:
        mode = "dense"
    if mode == "pallas" and s.continual_reg_on and not fused_windows:
        mode = "fused"
    if mode not in ("dense", "sparse", "fused", "pallas"):
        raise ValueError(f"unknown feature_update {settings.feature_update!r}")
    return mode


def batch_windows_ok(settings: TrainSettings, feat_shapes, fused: bool) -> bool:
    """Can epoch windows in the ``fused`` (one K2 launch per step) or
    per-level (one K1 launch per level) layout run these settings?  The
    JAX package's predicate (trainer.py:174) with the layout as an argument:
    there it resolves as if fused windows were coming, so per-level windows
    under continual-learning reg slip past it.  The fused layout also needs
    one feature dim across levels, as the kernel's multi-level launch does.
    Windows need ``pre_lookups`` besides: an argument, not a setting."""
    s = settings
    if fused and len({int(D) for _, D in feat_shapes}) != 1:
        return False
    return (resolve_feature_update(s, fused_windows=fused) == "pallas"
            and not s.fuse_update_levels and not s.ray_loss
            and not s.consistency_loss_on)


def init_params(cfg, grid, generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
    """Canonical parameters: geo/sem decoders, the grid's feature tables (the
    same tensors, trained in place) and the dr-loss sigma."""
    device = grid.features[0].device

    def dec(hidden, level, bias):
        return Decoder(cfg.feature_dim, hidden, level, cfg.sem_class_count,
                       bias, generator=generator, device=device)

    return {
        "geo": dec(cfg.geo_mlp_hidden_dim, cfg.geo_mlp_level, cfg.geo_mlp_bias_on),
        "sem": dec(cfg.sem_mlp_hidden_dim, cfg.sem_mlp_level, cfg.sem_mlp_bias_on),
        FEATURES: list(grid.features),
        "sigma": torch.ones((), dtype=torch.float32, device=device),
    }


def pool_to_device(pool, capacity: int, device="cuda", subset=None):
    """Pad the host pool to ``capacity`` and upload the point-mode fields
    (the ray, normal, origin, time and semantic fields arrive with the
    options that read them).  ``subset``: host indices of the samples to
    upload instead of all (the rotating sub-pools of a pool larger than the
    device budget, JAX ``pool_to_device(subset=)``).

    Returns (device pool dict, n_valid)."""
    if subset is not None:
        pool = _subset_pool(pool, subset)
    n = len(pool)
    if capacity < n:
        raise ValueError(f"pool of {n} samples exceeds capacity {capacity}")

    def pad(a):
        out = np.zeros((capacity,) + a.shape[1:], a.dtype)
        out[:n] = a
        return torch.from_numpy(out).to(device)

    dev = {
        "coord": pad(pool.coord),
        "sdf_label": pad(pool.sdf_label),
        "weight": pad(pool.weight),
    }
    return dev, n


def _subset_pool(pool, idx):
    """The host pool's samples ``idx`` (fields of another length, such as a
    ray pool's per-ray depths, kept whole)."""
    import copy

    sub = copy.copy(pool)
    for f in ("coord", "sdf_label", "normal_label", "sem_label", "weight",
              "sample_depth", "origin", "time"):
        a = getattr(pool, f)
        if a is not None and a.shape[0] == len(pool):
            setattr(sub, f, a[idx])
    return sub


@torch.no_grad()
def precompute_pool_lookups(tables: Sequence[LevelTable], pool_coord: torch.Tensor,
                            levels: Sequence[int], capacities: Sequence[int],
                            chunk: int = 1 << 16):
    """Corner rows and found masks of EVERY pool sample, per level: a tuple
    of ``(corners (N, 8) int32, found (N,) bool)``, misses forced to the
    trashbin row ``capacities[i] - 1`` (JAX ``precompute_pool_lookups``,
    trainer.py:1706).  The hash structure is frozen while the map does not
    grow and the pool does not change — a whole batch-mode run — so the
    per-step probes become gathers (``train_chunk(..., pre_lookups=...)``).
    The caller recomputes after growth or a new pool.  Probes ``chunk``
    samples at a time to bound the probe window's memory."""
    out = []
    for table, level, C in zip(tables, levels, capacities):
        cs, fs = [], []
        for a in range(0, pool_coord.shape[0], chunk):
            c, f = lookup_level(table, pool_coord[a:a + chunk], level)
            cs.append(torch.where(f[:, None], c, int(C) - 1))
            fs.append(f)
        out.append((torch.cat(cs), torch.cat(fs)))
    return tuple(out)


@dataclasses.dataclass
class BatchWindows:
    """Epoch windows with the update's row prep (:func:`precompute_batch_windows`).

    ``idx`` (W, bs) int64 pool indices of each window; ``fused``: the
    layout (one K2 launch per step over all levels, or one K1 launch per
    level); ``preps``: for ``fused`` one stacked :class:`EntryPrep` over all
    levels, else one per level (``adam_kernel.window_prep`` takes window
    w's)."""

    idx: torch.Tensor
    fused: bool
    preps: List[EntryPrep]

    @property
    def n_windows(self) -> int:
        return int(self.idx.shape[0])

    @property
    def built_for(self) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
        """(table rows, used heads) per level that the preps were built for."""
        return (sum((p.sizes for p in self.preps), ()),
                sum((p.n_used for p in self.preps), ()))


@torch.no_grad()
def precompute_batch_windows(pre_lookups, n_valid: int,
                             generator: Optional[torch.Generator],
                             settings: TrainSettings, feat_shapes, fused: bool = True,
                             window_indices: Optional[torch.Tensor] = None) -> BatchWindows:
    """Epoch-style batch windows, with the update's row prep computed once
    per window (JAX ``precompute_batch_windows``, trainer.py:1751, whose
    window membership ``precompute_batch_windows_fused`` shares).

    One permutation of the ``n_valid`` pool samples (``torch.randperm`` with
    ``generator``) is cut into W = ceil(n_valid / bs) windows; the tail
    wraps to the start of the permutation, so every sample trains each
    epoch.  Window indices are sorted when ``settings.sort_batch`` is set.
    ``train_chunk`` trains iteration ``t`` on window ``(start_iter + t) % W``.
    ``window_indices`` (W, bs) replaces the permutation with given windows —
    a test seam that lets a test hand across the JAX package's.

    ``fused`` picks the layout (``tpu.windows_fused``): one
    ``fused_adam_multi`` launch per step over all levels, with one
    :class:`EntryPrep` per window, or per-level ``fused_adam`` launches with
    one per level and window.  Both hold the same windows.  (The TPU's
    split-K layout, ``tpu.windows_split_k``, only reorders the samples
    inside a window for the TPU's gathers; it selects nothing here.)

    Raises ValueError before any training when the settings cannot run
    windows (:func:`batch_windows_ok`) or when an entry of some window lies
    past ``settings.n_used`` (a stale hint: recompute ``used_rows_for``).
    Device memory: :func:`estimate_windows_bytes`.  The caller recomputes
    the windows with ``pre_lookups``."""
    s = settings
    if not batch_windows_ok(s, feat_shapes, fused):
        raise ValueError(
            "batch_windows require the pallas update (feature_update: pallas, no "
            "fuse_update_levels), a point-mode loss without consistency or ray "
            "loss, no continual reg on the per-level layout, and for the fused "
            "layout one feature dim")
    sizes = [int(C) for C, _ in feat_shapes]
    n_used = list(s.n_used) if s.n_used is not None else sizes
    device = pre_lookups[0][0].device
    n_valid = int(n_valid)
    if window_indices is None:
        W = max(-(n_valid // -s.bs), 1)
        perm = torch.randperm(n_valid, generator=generator, device=device)
        perm = perm.repeat(-(W * s.bs // -n_valid))[: W * s.bs]
        idx = perm.reshape(W, s.bs)
    else:
        idx = window_indices.to(device=device, dtype=torch.int64)
        if idx.dim() != 2 or idx.shape[1] != s.bs:
            raise ValueError(f"window_indices must be (W, {s.bs})")
        if idx.numel() and not (0 <= int(idx.min()) and int(idx.max()) < n_valid):
            raise ValueError(f"window_indices must lie in [0, {n_valid})")
    if s.sort_batch:
        idx = torch.sort(idx, dim=1).values
    rows = [pre_lookups[i][0][idx] for i in range(len(sizes))]  # (W, bs, 8)
    D = int(feat_shapes[0][1])
    if fused:
        preps = [adam_kernel.entry_prep_stack(rows, sizes, n_used, D)]
    else:
        preps = [adam_kernel.entry_prep_stack([r], [C], [nu], int(sh[1]))
                 for r, C, nu, sh in zip(rows, sizes, n_used, feat_shapes)]
    dropped = sum(p.dropped for p in preps)
    bad = torch.nonzero(dropped).reshape(-1)
    if bad.numel():
        raise ValueError(
            f"{int(dropped.sum())} entries of windows {bad[:8].tolist()} lie past "
            f"the n_used heads {tuple(n_used)}: the hint is stale (recompute "
            "used_rows_for); nothing was trained")
    return BatchWindows(idx=idx, fused=fused, preps=preps)


def estimate_windows_bytes(n_valid: int, settings: TrainSettings, feat_shapes) -> int:
    """Device bytes :func:`precompute_batch_windows` holds for a run (JAX
    ``estimate_windows_bytes``, trainer.py:1807, on the port's layout): per
    window the int64 indices and, per entry (bs x 8 corners x L levels),
    an int32 row and an int32 order, plus per prep an int64 dropped count
    and an int32 offset per tile of the update kernel and one more
    (``feat_shapes``: the tables' (C_l, D)).  Counted for the per-level
    layout, whose L preps hold L - 1 tile offsets more than the fused one."""
    s = settings
    W = max(-(int(n_valid) // -s.bs), 1)
    L = len(s.levels)
    sizes = [int(C) for C, _ in feat_shapes]
    n_used = list(s.n_used) if s.n_used is not None else sizes
    tiles = sum(-(-nu // adam_kernel.tile_rows(D)) for nu, (_, D) in zip(n_used, feat_shapes))
    return W * (8 * s.bs + 8 * s.bs * 8 * L + 8 * L + 4 * (tiles + L))


def _gather_batch(pool, idx):
    return {
        "coord": pool["coord"][idx],
        "sdf_label": pool["sdf_label"][idx],
        "weight": pool["weight"][idx],
    }


def _feat_from_rows(c, G_l, found_l, s: TrainSettings):
    """Interpolated hierarchical feature from the gathered corner rows
    ``G_l[i]`` (B, 8, D); misses (``found`` False) contribute zero."""
    f = None
    for i, level in enumerate(s.levels):
        w = corner_weights(c, level, s.poly_int_on)
        w = torch.where(found_l[i][:, None], w, torch.zeros_like(w))
        contrib = torch.einsum("nc,ncd->nd", w.to(G_l[i].dtype), G_l[i])
        f = contrib if f is None else f + contrib
    return f


def _compute_loss_sparse(geo: Decoder, G_list, batch, found, s: TrainSettings):
    """Loss with the feature tables factored out as gathered rows ``G_list``.

    The field is linear in the rows given the (fixed) structure, so
    d loss/d table = scatter-add of d loss/d G over the corner rows — the
    kernel applies that scatter inside the Adam sweep.  Returns
    (total, aux)."""
    weight = batch["weight"]
    surface_mask = weight > 0
    aux: Dict[str, torch.Tensor] = {}
    coords = batch["coord"].detach().requires_grad_(s.ekional_loss_on)

    pred = geo.sdf(_feat_from_rows(coords, G_list, found, s))
    if s.ekional_loss_on:
        # d pred / d coord with a graph, so the eikonal term trains the rows
        # and the decoder through a second-order backward
        (g,) = torch.autograd.grad(pred.sum(), coords, create_graph=True)
        g = g * s.sigma_sigmoid

    w = torch.abs(weight)
    target = batch["sdf_label"]
    if s.main_loss_type == "sdf_bce":
        sdf_loss = losses.sdf_bce_loss(
            pred, target, s.sigma_sigmoid, w, s.loss_weight_on, s.loss_reduction)
    elif s.main_loss_type == "sdf_l1":
        sdf_loss = losses.sdf_diff_loss(pred, target, w, s.scale, False)
    elif s.main_loss_type == "sdf_l2":
        sdf_loss = losses.sdf_diff_loss(pred, target, w, s.scale, True)
    else:
        raise NotImplementedError(
            f"main_loss_type {s.main_loss_type!r}: ROADMAP Queue A item 15")
    total = sdf_loss
    aux["sdf_loss"] = sdf_loss
    if s.ekional_loss_on:
        ek = losses.eikonal_loss(g, surface_mask)
        total = total + s.weight_e * ek
        aux["eikonal_loss"] = ek
    aux["total_loss"] = total
    return total, aux


def _gather_rows(feats, corners):
    """The gathered corner rows ``G_i`` (B, 8, D), widened to float32 (bf16
    tables), as leaf tensors that collect d loss / d row."""
    G = [f[c.long()].float() for f, c in zip(feats, corners)]
    for g_i in G:
        g_i.requires_grad_()
    return G


def _lookup_rows(tables, feats, coords, s: TrainSettings):
    """Per level: the containing node's corner rows (misses -> the trashbin
    row; a missed probe lands on an arbitrary slot whose rows may belong to
    a real node), the found mask, and the gathered rows ``G_i``."""
    corners, found = [], []
    with torch.no_grad():
        for i, level in enumerate(s.levels):
            c_i, f_i = lookup_level(tables[i], coords, level)
            trash = torch.full_like(c_i, feats[i].shape[0] - 1)
            corners.append(torch.where(f_i[:, None], c_i, trash))
            found.append(f_i)
    return corners, found, _gather_rows(feats, corners)


def batch_loss(params, tables, pool, idx, settings: TrainSettings) -> Dict[str, torch.Tensor]:
    """The training loss terms on the pool samples ``idx``, without a step
    (the eikonal term still differentiates the field w.r.t. the points)."""
    batch = _gather_batch(pool, idx)
    _, found, G = _lookup_rows(tables, params[FEATURES], batch["coord"], settings)
    _, aux = _compute_loss_sparse(params["geo"], G, batch, found, settings)
    return {k: a.detach() for k, a in aux.items()}


def _check_supported(s: TrainSettings, batch_sharding, batch_windows) -> None:
    """Raise NotImplementedError, naming the ROADMAP item, for what this
    slice of the port does not run yet."""
    todo = []
    if not s.opt_adam:
        todo.append("SGD (Queue A item 15)")
    if s.feature_update not in ("fused", "pallas"):
        todo.append(f"feature_update {s.feature_update!r} "
                    "(sparse: Queue A item 13; dense: item 15)")
    for flag in ("ray_loss", "normal_loss_on", "consistency_loss_on",
                 "proj_correction_on", "semantic_on", "time_conditioned"):
        if getattr(s, flag):
            todo.append(f"{flag} (Queue A item 15)")
    if s.continual_reg_on or s.freeze_decoder:
        todo.append("continual_reg_on / freeze_decoder (Queue A item 10)")
    if s.sort_batch and batch_windows is None:
        # windows sort their indices once, at precompute
        todo.append("sort_batch on iid batches (Queue A item 15)")
    if batch_sharding is not None:
        todo.append("multi-GPU batch sharding (Queue A item 14)")
    if todo:
        raise NotImplementedError("not ported yet, see ROADMAP.md: " + "; ".join(todo))


def _check_modes(s: TrainSettings, feats, m_feats, n_used, pre_lookups,
                 batch_windows, batch_indices, sr_noise16, n_iters) -> None:
    """The JAX package's gates (trainer.py:756-836): windows need their
    prerequisites, bf16 moments the kernel update, bf16 tables fused
    windows and bf16 moments.  Raises ValueError."""
    shapes = [tuple(f.shape) for f in feats]
    fused_windows = batch_windows is not None and batch_windows.fused
    mode = resolve_feature_update(s, fused_windows)
    if pre_lookups is not None and len(pre_lookups) != len(s.levels):
        raise ValueError(f"pre_lookups must hold one (corners, found) per level, "
                         f"got {len(pre_lookups)}")
    if batch_windows is not None:
        if pre_lookups is None or not batch_windows_ok(s, shapes, batch_windows.fused):
            raise ValueError(
                "batch_windows requires the pallas update (feature_update: pallas, "
                "no fuse_update_levels), point-mode loss without consistency, and "
                f"pre_lookups (mode: {mode})")
        if batch_indices is not None:
            raise ValueError("batch_indices and batch_windows both choose the batches")
        built = batch_windows.built_for
        if built != (tuple(sh[0] for sh in shapes), tuple(n_used)):
            raise ValueError(f"batch_windows were built for (sizes, n_used) {built}, "
                             f"the tables have {tuple(sh[0] for sh in shapes)}, "
                             f"{tuple(n_used)}: recompute them")
    moments_bf16 = m_feats[0].dtype == torch.bfloat16
    if moments_bf16 and mode != "pallas":
        raise ValueError("tpu.moments_bf16 requires feature_update: pallas "
                         f"(resolved mode: {mode})")
    if feats[0].dtype == torch.bfloat16 and not (fused_windows and moments_bf16):
        # every other update would round to nearest and stall sub-quantum steps
        raise ValueError("tpu.params_bf16 requires fused batch windows "
                         "(batch_windows + windows_fused) and moments_bf16")
    if sr_noise16 is not None:
        if feats[0].dtype != torch.bfloat16:
            raise ValueError("sr_noise16 feeds the stochastic rounding of bf16 tables")
        total = sum(int(f.numel()) for f in feats)
        if tuple(sr_noise16.shape) != (n_iters, total):
            raise ValueError(f"sr_noise16 must be ({n_iters}, {total})")


def train_chunk(
    params: Dict[str, Any],
    opt_state: OptState,
    tables: Sequence[LevelTable],
    pool: Dict[str, torch.Tensor],
    n_valid: int,
    start_iter: int,
    generator: Optional[torch.Generator],
    settings: TrainSettings,
    n_iters: int,
    batch_sharding=None,
    pre_lookups=None,
    batch_windows: Optional[BatchWindows] = None,
    batch_indices: Optional[torch.Tensor] = None,
    sr_noise16: Optional[torch.Tensor] = None,
):
    """Run ``n_iters`` optimization steps, updating ``params`` and
    ``opt_state`` in place.

    Batches are ``bs`` indices drawn uniformly from [0, n_valid) with
    ``generator`` (a torch.Generator on the pool's device), or, with
    ``batch_windows`` (:func:`precompute_batch_windows`), window
    ``(start_iter + t) % W`` at iteration ``t``, whose update row prep comes
    precomputed; its layout picks the update (one ``fused_adam_multi`` or
    per-level ``fused_adam``).  Windows need ``pre_lookups``
    (:func:`precompute_pool_lookups` of the SAME tables and pool), which
    also serve iid batches: the per-step hash probes become gathers.
    ``batch_indices`` (n_iters, bs) replaces the iid draw with given indices
    — a test seam that lets a test feed the JAX package's draws.

    The table dtypes pick the bf16 modes: bf16 feature moments
    (``init_opt_state(moments_bf16=True)``, gradient entries rounded to
    bf16) need ``feature_update: pallas``; bf16 tables
    (``HashGridHost.cast_features``) need fused windows and bf16 moments,
    and take stochastic rounding seeded with ``start_iter + t``.
    ``sr_noise16`` (n_iters, sum of the tables' elements) hands the plain
    version (CPU tensors) each step's 16-bit rounding noise, the levels'
    tables concatenated in row-major order — a test seam for the JAX
    package's bits.

    Returns (params, opt_state, {"mean": aux means, "last": last aux}), the
    aux values 0-dim tensors on the device.

    Raises ValueError at the end of the chunk if gradient entries of iid
    batches fell past the ``settings.n_used`` heads (a stale hint; windows
    check this before training).  The steps have then already been applied
    in place without those entries: the tables and moments are not the
    reference's and should be discarded.
    """
    s = settings
    _check_supported(s, batch_sharding, batch_windows)
    if batch_indices is None and generator is None and batch_windows is None:
        raise ValueError("pass a torch.Generator, batch_indices or batch_windows")
    if batch_indices is not None and tuple(batch_indices.shape) != (n_iters, s.bs):
        raise ValueError(f"batch_indices must be ({n_iters}, {s.bs})")
    # the reference trains in full float32; TF32 would keep ~3 decimal digits
    # in the decoder's matmuls and the interpolation's batched products and
    # move the trajectory away from the reference (and the JAX package)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    feats: List[torch.Tensor] = list(params[FEATURES])
    m_feats = list(opt_state.m[FEATURES])
    v_feats = list(opt_state.v[FEATURES])
    device = feats[0].device
    n_used = list(s.n_used) if s.n_used is not None else [int(f.shape[0]) for f in feats]
    _check_modes(s, feats, m_feats, n_used, pre_lookups, batch_windows, batch_indices,
                 sr_noise16, n_iters)
    grads_bf16 = m_feats[0].dtype == torch.bfloat16
    params_bf16 = feats[0].dtype == torch.bfloat16
    lr_scale, wd = make_group_trees(params, s.lr_level_reduce_ratio, s.weight_decay)
    dense = dense_params(params)
    geo: Decoder = params["geo"]

    dropped = torch.zeros((), dtype=torch.int64, device=device)
    hist: List[Dict[str, torch.Tensor]] = []
    for it in range(n_iters):
        step = start_iter + it
        if batch_windows is not None:
            wsel = step % batch_windows.n_windows
            idx = batch_windows.idx[wsel]
        elif batch_indices is not None:
            idx = batch_indices[it].to(device=device, dtype=torch.int64)
        else:
            idx = torch.randint(0, int(n_valid), (s.bs,), generator=generator,
                                device=device)
        batch = _gather_batch(pool, idx)
        if pre_lookups is not None:
            corners = [pre_lookups[i][0][idx] for i in range(len(s.levels))]
            found = [pre_lookups[i][1][idx] for i in range(len(s.levels))]
            G = _gather_rows(feats, corners)
        else:
            corners, found, G = _lookup_rows(tables, feats, batch["coord"], s)
        for p in dense.values():
            p.grad = None

        total, aux = _compute_loss_sparse(geo, G, batch, found, s)
        total.backward()

        lr = lr_at_step(s.lr, step, s.lr_decay_step, s.lr_iters_reduce_ratio)
        adam_update(dense, {k: p.grad for k, p in dense.items()}, opt_state, lr,
                    lr_scale, wd, b1=0.9, b2=0.99, eps=s.adam_eps)
        bc1, bc2 = bias_corrections(opt_state.step)
        grads = [g_i.grad for g_i in G]
        kw = dict(eps=s.adam_eps, grads_bf16=grads_bf16)
        if batch_windows is not None and batch_windows.fused:
            noise = None
            if sr_noise16 is not None:
                noise = torch.split(sr_noise16[it], [int(f.numel()) for f in feats])
            adam_kernel.fused_adam_multi(
                feats, m_feats, v_feats, corners, grads, lr, bc1, bc2,
                lr_scale[FEATURES], n_used, sr_seed=step if params_bf16 else None,
                pre=adam_kernel.window_prep(batch_windows.preps[0], wsel),
                noise16=noise, **kw)
        elif batch_windows is not None:
            for i in range(len(s.levels)):
                adam_kernel.fused_adam(
                    feats[i], m_feats[i], v_feats[i], corners[i], grads[i],
                    lr * lr_scale[FEATURES][i], bc1, bc2, n_used[i],
                    pre=adam_kernel.window_prep(batch_windows.preps[i], wsel), **kw)
        elif s.fuse_update_levels:
            dropped += adam_kernel.fused_adam_multi(
                feats, m_feats, v_feats, corners, grads, lr, bc1, bc2,
                lr_scale[FEATURES], n_used, **kw)
        else:
            for i in range(len(s.levels)):
                dropped += adam_kernel.fused_adam(
                    feats[i], m_feats[i], v_feats[i], corners[i], grads[i],
                    lr * lr_scale[FEATURES][i], bc1, bc2, n_used[i], **kw)
        hist.append({k: a.detach() for k, a in aux.items()})

    n_dropped = int(dropped)
    if n_dropped:
        raise ValueError(
            f"{n_dropped} gradient entries fell past the n_used heads "
            f"{tuple(n_used)}: the hint is stale (recompute used_rows_for); the "
            "chunk's steps were applied without them, so discard these tables")
    if not hist:
        return params, opt_state, {"mean": {}, "last": {}}
    stacked = {k: torch.stack([h[k] for h in hist]) for k in hist[0]}
    return params, opt_state, {
        "mean": {k: a.mean() for k, a in stacked.items()},
        "last": {k: a[-1] for k, a in stacked.items()},
    }
