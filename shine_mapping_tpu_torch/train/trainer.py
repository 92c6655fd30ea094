"""Training loop: sample batch -> query grid -> MLP -> losses -> Adam.

Port of ``shine_mapping_tpu/train/trainer.py``'s single-card
``train_chunk``: ``feature_update`` ``fused`` or ``pallas`` (JAX
``body_fused``, trainer.py:1106, and with fused epoch windows ``body_winx``,
:1391), ``sparse`` (lazy Adam on the touched rows, ``body_sparse``, :1022)
and ``dense`` (autodiff through the table gather and Adam or SGD over whole
tables, ``body_dense``, :1001, which also runs SGD).  One kernel step:

1. take ``bs`` pool indices — iid draws, or epoch window ``(start_iter + t)
   % W`` (:func:`precompute_batch_windows`) — and gather the batch;
2. per level, the 8 corner rows of the containing node: a hash lookup
   (``hashgrid.lookup_level``), or a gather from lookups resolved once per
   pool (:func:`precompute_pool_lookups`); misses -> the trashbin row; then
   gather the rows ``G_i`` (widened to float32 from bf16 tables);
3. interpolate and decode (``feat_from_rows``, ``decoder.sdf`` or
   ``time_conditioned_sdf``), take the loss (``_compute_loss_sparse``: the
   sdf_bce / sdf_l1 / sdf_l2 or dr / dr_neus main term, eikonal, normal,
   consistency on jittered near points, the semantic NLL; the point-gradient
   terms differentiate the field w.r.t. the points, so the backward is
   second order);
4. Adam on the decoders (``optimizer.adam_update``);
5. the dense Adam step on the feature tables through the fused kernel
   (``ops/adam_kernel.py``), fed with the gathered rows' gradients: one
   launch per level (K1) or one over all levels (K2), with the row prep of
   a window precomputed.  The consistency term's near points add their rows
   and gradients to the batch's as extra entries.

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

Continual learning (the incremental driver): ``continual_reg_on`` adds the
reference's feature regularizer ``lambda * sum imp * (p - last)^2`` over
the batch's touched rows (model/feature_octree.py:246-255; JAX
``body_fused``, trainer.py:1357-1373, and the fused-window fold of
``body_winx``, :1520-1547).  Its gradient ``2 lambda imp (p - last)`` rides
the kernel's gradient entries: each touched row has one owner entry, its
first (sample, corner) among the batch's found corners, and the term is
added to that entry in float32 before the launch (and before any bf16
rounding of the entries), so the entry count stays ``bs * 8`` per level.
Fused windows precompute the owner flags (``reg_cover``); iid batches
compute them per step.  ``freeze_decoder`` zeroes the decoders' lr while
their Adam state still advances (trainer.py:927-932).
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
from . import losses, sparse_adam
from .optimizer import (
    FEATURES,
    OptState,
    adam_leaf,
    adam_update,
    bias_corrections,
    dense_params,
    lr_at_step,
    make_group_trees,
    sgd_leaf,
    sgd_update,
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
    """Canonical parameters: geo/sem decoders (geo's input D + 1 when
    time-conditioned), the grid's feature tables (the same tensors, trained
    in place) and the dr-loss sigma (trained with the decoders)."""
    device = grid.features[0].device

    def dec(hidden, level, bias, tc=False):
        return Decoder(cfg.feature_dim, hidden, level, cfg.sem_class_count,
                       bias, generator=generator, device=device, time_conditioned=tc)

    return {
        "geo": dec(cfg.geo_mlp_hidden_dim, cfg.geo_mlp_level, cfg.geo_mlp_bias_on,
                   cfg.time_conditioned),
        "sem": dec(cfg.sem_mlp_hidden_dim, cfg.sem_mlp_level, cfg.sem_mlp_bias_on),
        FEATURES: list(grid.features),
        "sigma": torch.ones((), dtype=torch.float32, device=device),
    }


def pool_to_device(pool, capacity: int, device="cuda", subset=None,
                   settings: Optional[TrainSettings] = None):
    """Pad the host pool to ``capacity`` and upload the fields training reads
    (JAX ``pool_to_device``, trainer.py:2397): coord, sdf_label, weight and
    time always; with ``settings``, the sample depths and per-ray depths
    (``ray_loss``: the pool is ray-major, ``capacity // ray_sample_count``
    rays), the normals (``normal_loss_on``), the ray origins
    (``proj_correction_on``) and the labels (``semantic_on``) where the pool
    has them.  ``subset``: host indices of the samples to upload instead of
    all (the rotating sub-pools of a pool larger than the device budget,
    JAX ``pool_to_device(subset=)``).

    Returns (device pool dict, n_valid)."""
    if subset is not None:
        pool = _subset_pool(pool, subset)
    n = len(pool)
    if capacity < n:
        raise ValueError(f"pool of {n} samples exceeds capacity {capacity}")

    def pad(a, cap=capacity):
        out = np.zeros((cap,) + a.shape[1:], a.dtype)
        out[:a.shape[0]] = a
        return torch.from_numpy(out).to(device)

    dev = {
        "coord": pad(pool.coord),
        "sdf_label": pad(pool.sdf_label),
        "weight": pad(pool.weight),
        "time": pad(pool.time),
    }
    s = settings
    if s is not None and s.ray_loss:
        dev["sample_depth"] = pad(pool.sample_depth)
        dev["ray_depth"] = pad(pool.ray_depth, capacity // s.ray_sample_count)
    if s is not None and s.normal_loss_on and pool.normal_label is not None:
        dev["normal_label"] = pad(pool.normal_label)
    if s is not None and s.proj_correction_on:
        dev["origin"] = pad(pool.origin)
    if s is not None and s.semantic_on and pool.sem_label is not None:
        dev["sem_label"] = pad(pool.sem_label)
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
    # continual-learning reg: per level, (W, bs, 8) bool owner flags
    # (:func:`owner_flags` of each window), or None
    owner: Optional[List[torch.Tensor]] = None

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
                             window_indices: Optional[torch.Tensor] = None,
                             reg_cover: bool = False) -> BatchWindows:
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

    ``reg_cover`` also stores each window's reg owner flags
    (:func:`owner_flags`, one bool per entry: JAX's ``reg_cover`` masks,
    trainer.py:2250-2298, which pack a slot bit per lane and overflow an
    int32 below feature_dim 4; a flag per entry has no width to overflow).
    ``train_chunk`` needs them under ``continual_reg_on``.

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
    owner = None
    if reg_cover:
        owner = [owner_flags(rows[i], pre_lookups[i][1][idx]) for i in range(len(sizes))]
    return BatchWindows(idx=idx, fused=fused, preps=preps, owner=owner)


def estimate_windows_bytes(n_valid: int, settings: TrainSettings, feat_shapes,
                           reg_cover: bool = False) -> int:
    """Device bytes :func:`precompute_batch_windows` holds for a run (JAX
    ``estimate_windows_bytes``, trainer.py:1807, on the port's layout): per
    window the int64 indices and, per entry (bs x 8 corners x L levels),
    an int32 row and an int32 order (and with ``reg_cover`` a bool owner
    flag), plus per prep an int64 dropped count and an int32 offset per
    tile of the update kernel and one more (``feat_shapes``: the tables'
    (C_l, D)).  Counted for the per-level layout, whose L preps hold L - 1
    tile offsets more than the fused one."""
    s = settings
    W = max(-(int(n_valid) // -s.bs), 1)
    L = len(s.levels)
    sizes = [int(C) for C, _ in feat_shapes]
    n_used = list(s.n_used) if s.n_used is not None else sizes
    tiles = sum(-(-nu // adam_kernel.tile_rows(D)) for nu, (_, D) in zip(n_used, feat_shapes))
    per_entry = 8 + (1 if reg_cover else 0)
    return W * (8 * s.bs + per_entry * s.bs * 8 * L + 8 * L + 4 * (tiles + L))


def owner_flags(corners: torch.Tensor, found: torch.Tensor) -> torch.Tensor:
    """Which gradient entries carry the continual-learning reg: of a batch's
    corner rows ``corners`` (..., B, 8) and found masks ``found`` (..., B),
    the first (sample, corner), in sample-major order, of each row that a
    found sample touches (a stable sort over the batch's ``B * 8`` entries;
    JAX's cover masks choose the same owner, trainer.py:2250-2262).
    Returns (..., B, 8) bool; misses own nothing, so the trashbin row
    takes no reg."""
    lead, B = corners.shape[:-2], corners.shape[-2]
    rows = torch.where(found[..., None], corners.to(torch.int64), -1).reshape(*lead, B * 8)
    srt, order = torch.sort(rows, dim=-1, stable=True)
    first = torch.ones_like(srt, dtype=torch.bool)
    first[..., 1:] = srt[..., 1:] != srt[..., :-1]
    first &= srt >= 0
    own = torch.zeros_like(first).scatter_(-1, order, first)
    return own.reshape(corners.shape)


def _reg_fold(s: TrainSettings, shadow, corners, G, grads, owner):
    """The continual-learning reg on each level's owner entries: returns the
    gradient entries with ``2 lambda imp (p - last)`` added in float32 on
    the owner entries (new tensors, the kernel's input), and the reg
    ``sum imp (p - last)^2`` over them (JAX body_fused's dense form,
    trainer.py:1364-1373: touched rows once each)."""
    out, reg = [], None
    for i in range(len(s.levels)):
        rows = corners[i].long()
        imp = shadow["importance"][i][rows]
        diff = G[i].detach() - shadow["last_frame"][i][rows].float()
        own = owner[i][..., None]
        out.append(grads[i] + torch.where(own, (2.0 * s.lambda_forget) * imp * diff, 0.0))
        term = torch.where(own, imp * diff * diff, 0.0).sum()
        reg = term if reg is None else reg + term
    return out, reg


def _gather_batch(pool, idx, s: TrainSettings):
    """The batch's fields (JAX ``_gather_batch``, trainer.py:632): those
    every loss reads, the timestamps as ``ts``, and the fields of the
    options that are on."""
    batch = {
        "coord": pool["coord"][idx],
        "sdf_label": pool["sdf_label"][idx],
        "weight": pool["weight"][idx],
    }
    if "time" in pool:
        batch["ts"] = pool["time"][idx]
    if s.ray_loss:
        batch["sample_depth"] = pool["sample_depth"][idx]
    if s.normal_loss_on:
        batch["normal_label"] = pool["normal_label"][idx]
    if s.proj_correction_on:
        batch["origin"] = pool["origin"][idx]
    if s.semantic_on:
        batch["sem_label"] = pool["sem_label"][idx]
    return batch


def feat_from_rows(c, G_l, found_l, levels: Sequence[int], poly_on: bool):
    """Interpolated hierarchical feature from the gathered corner rows
    ``G_l[i]`` (B, 8, D) of ``levels``; misses (``found`` False) contribute
    zero."""
    f = None
    for i, level in enumerate(levels):
        w = corner_weights(c, level, poly_on)
        w = torch.where(found_l[i][:, None], w, torch.zeros_like(w))
        contrib = torch.einsum("nc,ncd->nd", w.to(G_l[i].dtype), G_l[i])
        f = contrib if f is None else f + contrib
    return f


def _need_point_grad(s: TrainSettings) -> bool:
    return (s.ekional_loss_on or s.normal_loss_on or s.proj_correction_on
            or s.consistency_loss_on)


def _compute_loss_sparse(params, G_list, batch, found, s: TrainSettings, near=None):
    """Loss with the feature tables factored out as gathered rows ``G_list``
    (JAX ``_compute_loss_sparse``, trainer.py:508, and ``_compute_loss``,
    :296, whose terms it shares).

    The field is linear in the rows given the (fixed) structure, so
    d loss/d table = scatter-add of d loss/d G over the corner rows — the
    kernel applies that scatter inside the Adam sweep.  ``near`` (the
    consistency term) holds the jittered near points: ``idx`` (their source
    samples), ``coords``, ``found`` and their rows ``G``, whose gradients
    scatter like the batch's.  Every term, the point gradients' included, is
    differentiated w.r.t. the parameters, as JAX's autodiff does (the
    projective correction's cosine included).  Returns (total, aux)."""
    geo: Decoder = params["geo"]
    weight = batch["weight"]
    surface_mask = weight > 0
    aux: Dict[str, torch.Tensor] = {}
    need_grad = _need_point_grad(s)
    coords = batch["coord"].detach().requires_grad_(need_grad)

    def pred_of(feat, ts):
        if s.time_conditioned:
            return geo.time_conditioned_sdf(feat, ts)
        return geo.sdf(feat)

    feat = feat_from_rows(coords, G_list, found, s.levels, s.poly_int_on)
    pred = pred_of(feat, batch.get("ts"))
    if need_grad:
        # d pred / d coord with a graph, so the point-gradient terms train
        # the rows and the decoder through a second-order backward
        (g,) = torch.autograd.grad(pred.sum(), coords, create_graph=True)
        g = g * s.sigma_sigmoid

    target = batch["sdf_label"]
    if s.proj_correction_on:
        # scale the surface samples' projective labels by |cos(grad, ray)|;
        # free-space samples keep cos = 1 (shine_batch.py:144-147)
        ray = batch["coord"] - batch["origin"]
        cos = torch.abs(torch.sum(g * ray, dim=-1)
                        / (losses.safe_norm(g, dim=-1) * losses.safe_norm(ray, dim=-1)
                           + 1e-12))
        cos = torch.where(surface_mask, cos, torch.ones_like(cos))
        target = target * cos

    if s.ray_loss:
        # rendering losses over rays (shine_batch.py:162-170)
        pred_occ = torch.sigmoid(pred / params["sigma"])
        pred_ray = pred_occ.reshape(-1, s.ray_sample_count)
        depth_ray = batch["sample_depth"].reshape(-1, s.ray_sample_count)
        sdf_loss = losses.batch_ray_rendering_loss(
            depth_ray, pred_ray, batch["ray_depth"], neus_on=(s.main_loss_type == "dr_neus"))
    else:
        w = torch.abs(weight)
        if s.main_loss_type == "sdf_bce":
            sdf_loss = losses.sdf_bce_loss(
                pred, target, s.sigma_sigmoid, w, s.loss_weight_on, s.loss_reduction)
        elif s.main_loss_type == "sdf_l1":
            sdf_loss = losses.sdf_diff_loss(pred, target, w, s.scale, False)
        elif s.main_loss_type == "sdf_l2":
            sdf_loss = losses.sdf_diff_loss(pred, target, w, s.scale, True)
        else:
            raise ValueError(f"unknown main_loss_type {s.main_loss_type}")
    total = sdf_loss
    aux["sdf_loss"] = sdf_loss
    if s.ekional_loss_on:
        ek = losses.eikonal_loss(g, surface_mask)
        total = total + s.weight_e * ek
        aux["eikonal_loss"] = ek
    if s.consistency_loss_on:
        # gradient agreement between jittered nearby points
        # (shine_batch.py:149-158, 187-190)
        cn = near["coords"].detach().requires_grad_(True)
        fn = feat_from_rows(cn, near["G"], near["found"], s.levels, s.poly_int_on)
        ts_n = batch["ts"][near["idx"]] if s.time_conditioned else None
        (gn,) = torch.autograd.grad(pred_of(fn, ts_n).sum(), cn, create_graph=True)
        cons = losses.consistency_loss(g[near["idx"]], gn * s.sigma_sigmoid)
        total = total + s.weight_c * cons
        aux["consistency_loss"] = cons
    if s.normal_loss_on:
        nl = losses.normal_loss(g, batch["normal_label"], surface_mask)
        total = total + s.weight_n * nl
        aux["normal_loss"] = nl
    if s.semantic_on:
        sem_pred = params["sem"].sem_label_prob(feat)
        d = s.sem_label_decimation
        sl = losses.sem_nll_loss(sem_pred[::d], batch["sem_label"][::d])
        total = total + s.weight_s * sl
        aux["sem_loss"] = sl
    aux["total_loss"] = total
    return total, aux


def _gather_rows(feats, corners, leaf: bool = True):
    """The gathered corner rows ``G_i`` (B, 8, D), widened to float32 (bf16
    tables): leaf tensors that collect d loss / d row, or, with ``leaf``
    False, gathers that pass the gradient on to tables that require it (the
    dense update's autodiff)."""
    G = [f[c.long()].float() for f, c in zip(feats, corners)]
    if leaf:
        for g_i in G:
            g_i.requires_grad_()
    return G


def _lookups(tables, feats, coords, levels: Sequence[int]):
    """Per level: the containing node's corner rows (misses -> the trashbin
    row; a missed probe lands on an arbitrary slot whose rows may belong to
    a real node) and the found mask."""
    corners, found = [], []
    with torch.no_grad():
        for i, level in enumerate(levels):
            c_i, f_i = lookup_level(tables[i], coords, level)
            trash = torch.full_like(c_i, feats[i].shape[0] - 1)
            corners.append(torch.where(f_i[:, None], c_i, trash))
            found.append(f_i)
    return corners, found


def lookup_rows(tables, feats, coords, levels: Sequence[int]):
    """:func:`_lookups` and the gathered rows ``G_i`` (leaf tensors)."""
    corners, found = _lookups(tables, feats, coords, levels)
    return corners, found, _gather_rows(feats, corners)


def batch_loss(params, tables, pool, idx, settings: TrainSettings) -> Dict[str, torch.Tensor]:
    """The training loss terms on the pool samples ``idx``, without a step
    (the point-gradient terms still differentiate the field w.r.t. the
    points).  Point-mode terms only: no consistency or ray loss."""
    s = dataclasses.replace(settings, consistency_loss_on=False, ray_loss=False,
                            main_loss_type=("sdf_bce" if settings.ray_loss
                                            else settings.main_loss_type))
    batch = _gather_batch(pool, idx, s)
    _, found, G = lookup_rows(tables, params[FEATURES], batch["coord"], s.levels)
    _, aux = _compute_loss_sparse(params, G, batch, found, s)
    return {k: a.detach() for k, a in aux.items()}


def _check_supported(s: TrainSettings, batch_sharding) -> None:
    """Raise NotImplementedError, naming the ROADMAP item, for what the port
    does not run yet."""
    if batch_sharding is not None:
        raise NotImplementedError("not ported yet, see ROADMAP.md: multi-GPU batch "
                                  "sharding (Queue A item 14)")


def _check_modes(s: TrainSettings, mode, feats, m_feats, n_used, pool, pre_lookups,
                 batch_windows, batch_indices, sr_noise16, n_iters, shadow,
                 generator, near_indices, near_shifts) -> None:
    """The JAX package's gates (trainer.py:756-836): windows need their
    prerequisites, bf16 moments the kernel update, bf16 tables fused
    windows and bf16 moments, the continual reg its shadow tables and, on
    windows, their owner flags; and the inputs the options read.  Raises
    ValueError."""
    shapes = [tuple(f.shape) for f in feats]
    fused_windows = batch_windows is not None and batch_windows.fused
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
    if s.continual_reg_on:
        for key in ("importance", "last_frame"):
            tabs = None if shadow is None else shadow.get(key)
            if tabs is None or [tuple(t.shape) for t in tabs] != shapes:
                raise ValueError(f"continual_reg_on needs shadow[{key!r}]: one table per "
                                 f"level of the features' shapes {shapes}")
        if batch_windows is not None and batch_windows.owner is None:
            raise ValueError("continual_reg_on with fused windows needs the reg owner "
                             "flags: precompute_batch_windows(..., reg_cover=True)")
    for flag, field in (("ray_loss", "ray_depth"), ("normal_loss_on", "normal_label"),
                        ("proj_correction_on", "origin"), ("semantic_on", "sem_label"),
                        ("time_conditioned", "time")):
        if getattr(s, flag) and field not in pool:
            raise ValueError(f"{flag} needs the pool's {field!r}: upload it with "
                             "pool_to_device(..., settings=settings)")
    if s.ray_loss and s.main_loss_type not in ("dr", "dr_neus"):
        raise ValueError(f"ray_loss renders depth: main_loss_type dr or dr_neus, "
                         f"not {s.main_loss_type!r}")
    if s.consistency_loss_on:
        if (near_indices is None) != (near_shifts is None):
            raise ValueError("near_indices and near_shifts come together")
        if near_indices is None and generator is None:
            raise ValueError("the consistency term draws its near points with the "
                             "generator: pass one, or near_indices and near_shifts")
        if near_indices is not None:
            cnt = int(near_indices.shape[1])
            if (tuple(near_indices.shape) != (n_iters, cnt)
                    or tuple(near_shifts.shape) != (n_iters, cnt, 3)):
                raise ValueError(f"near_indices must be ({n_iters}, cnt) and near_shifts "
                                 f"({n_iters}, cnt, 3)")


def _near_points(s: TrainSettings, coords, it, generator, near_indices, near_shifts):
    """The consistency term's jittered near points of one step: ``cnt =
    min(consistency_count, B)`` batch samples (uniform, with replacement)
    shifted by U(-r, r) per axis, r = ``consistency_range * scale`` (JAX
    body_fused, trainer.py:1190-1198), or the given draws."""
    B = coords.shape[0]
    if near_indices is not None:
        idx = near_indices[it].to(device=coords.device, dtype=torch.int64)
        shift = near_shifts[it].to(device=coords.device, dtype=coords.dtype)
    else:
        cnt = min(s.consistency_count, B)
        r = s.consistency_range * s.scale
        idx = torch.randint(0, B, (cnt,), generator=generator, device=coords.device)
        shift = (torch.rand((cnt, 3), generator=generator, device=coords.device)
                 * (2 * r) - r).to(coords.dtype)
    return idx, coords[idx] + shift


def _dense_reg(s: TrainSettings, shadow, feats, corners):
    """The continual-learning reg of the dense update, differentiable in the
    tables: ``sum imp (p - last)^2`` over every row the batch's corners touch
    (JAX ``_continual_reg``, trainer.py:276-293)."""
    reg = None
    for i, f in enumerate(feats):
        touched = torch.zeros(f.shape[0], dtype=f.dtype, device=f.device)
        touched[corners[i].reshape(-1).long()] = 1.0
        diff = f - shadow["last_frame"][i]
        term = torch.sum(touched[:, None] * shadow["importance"][i] * diff * diff)
        reg = term if reg is None else reg + term
    return reg


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
    shadow: Optional[Dict[str, Sequence[torch.Tensor]]] = None,
    near_indices: Optional[torch.Tensor] = None,
    near_shifts: Optional[torch.Tensor] = None,
):
    """Run ``n_iters`` optimization steps, updating ``params`` and
    ``opt_state`` in place.

    Batches are ``bs`` indices drawn uniformly from [0, n_valid) with
    ``generator`` (a torch.Generator on the pool's device), sorted under
    ``sort_batch``; under ``ray_loss``, ``bs`` rays of the ray-major pool,
    each expanded to its ``ray_sample_count`` consecutive samples (JAX
    ``sample_batch``, trainer.py:969-988).  With ``batch_windows``
    (:func:`precompute_batch_windows`), window ``(start_iter + t) % W`` at
    iteration ``t``, whose update row prep comes precomputed; its layout
    picks the update (one ``fused_adam_multi`` or per-level ``fused_adam``).
    Windows need ``pre_lookups`` (:func:`precompute_pool_lookups` of the
    SAME tables and pool), which also serve iid batches in every mode: the
    per-step hash probes become gathers.  Test seams, for the JAX package's
    draws: ``batch_indices`` (n_iters, bs) replaces the iid draw (the ray
    indices under ``ray_loss``); ``near_indices`` (n_iters, cnt) and
    ``near_shifts`` (n_iters, cnt, 3) replace the consistency term's.

    The feature update is :func:`resolve_feature_update`'s: the kernel
    (``fused`` / ``pallas``), lazy Adam on the touched rows (``sparse``,
    :mod:`.sparse_adam`), or autodiff through the gather and Adam or, with
    ``opt_adam`` off, SGD over whole tables (``dense``).

    The table dtypes pick the bf16 modes: bf16 feature moments
    (``init_opt_state(moments_bf16=True)``, gradient entries rounded to
    bf16) need ``feature_update: pallas``; bf16 tables
    (``HashGridHost.cast_features``) need fused windows and bf16 moments,
    and take stochastic rounding seeded with ``start_iter + t``.
    ``sr_noise16`` (n_iters, sum of the tables' elements) hands the plain
    version (CPU tensors) each step's 16-bit rounding noise, the levels'
    tables concatenated in row-major order — a test seam for the JAX
    package's bits.

    ``shadow`` (``{"importance": [...], "last_frame": [...]}``, one table
    per level of the features' shapes; JAX ``train_chunk``'s ``shadow``)
    feeds ``settings.continual_reg_on``, which adds ``reg_loss`` to the aux
    and ``lambda * reg_loss`` to ``total_loss``.  The tables are read, never
    written; ``last_frame`` must not alias the trained features.

    Returns (params, opt_state, {"mean": aux means, "last": last aux}), the
    aux values 0-dim tensors on the device.

    Raises ValueError at the end of the chunk if gradient entries of iid
    batches fell past the ``settings.n_used`` heads (a stale hint; windows
    check this before training).  The steps have then already been applied
    in place without those entries: the tables and moments are not the
    reference's and should be discarded.
    """
    s = settings
    _check_supported(s, batch_sharding)
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
    mode = resolve_feature_update(s, batch_windows is not None and batch_windows.fused)
    _check_modes(s, mode, feats, m_feats, n_used, pool, pre_lookups, batch_windows,
                 batch_indices, sr_noise16, n_iters, shadow, generator, near_indices,
                 near_shifts)
    grads_bf16 = m_feats[0].dtype == torch.bfloat16
    params_bf16 = feats[0].dtype == torch.bfloat16
    lr_scale, wd = make_group_trees(params, s.lr_level_reduce_ratio, s.weight_decay)
    if s.freeze_decoder:
        # zero decoder lr = frozen; their Adam state still advances
        for k in lr_scale:
            if k.split(".", 1)[0] in ("geo", "sem"):
                lr_scale[k] = 0.0
    dense = dense_params(params)
    if "sigma" in dense and not dense["sigma"].requires_grad:
        # the rendering loss trains sigma with the decoders
        dense["sigma"].requires_grad_(True)
    L = len(s.levels)

    def one_step(step, it):
        """One step (JAX's scan body): the batch, the loss and its
        gradients, the decoders' and the tables' update; returns the aux."""
        wsel = None
        ray_idx = None
        if batch_windows is not None:
            wsel = step % batch_windows.n_windows
            idx = batch_windows.idx[wsel]
        else:
            if batch_indices is not None:
                draw = batch_indices[it].to(device=device, dtype=torch.int64)
            else:
                hi = int(n_valid) // s.ray_sample_count if s.ray_loss else int(n_valid)
                draw = torch.randint(0, hi, (s.bs,), generator=generator, device=device)
            if s.ray_loss:
                ray_idx = draw
                S = s.ray_sample_count
                idx = (ray_idx[:, None] * S + torch.arange(S, device=device)[None, :]).reshape(-1)
            else:
                idx = torch.sort(draw).values if s.sort_batch else draw
        batch = _gather_batch(pool, idx, s)
        if ray_idx is not None:
            batch["ray_depth"] = pool["ray_depth"][ray_idx]
        if pre_lookups is not None:
            corners = [pre_lookups[i][0][idx] for i in range(L)]
            found = [pre_lookups[i][1][idx] for i in range(L)]
        else:
            corners, found = _lookups(tables, feats, batch["coord"], s.levels)
        near = None
        if s.consistency_loss_on:
            n_idx, n_coords = _near_points(s, batch["coord"], it, generator, near_indices,
                                           near_shifts)
            # live probes even with pool lookups: the near points are not pool samples
            corners_n, found_n = _lookups(tables, feats, n_coords, s.levels)
            near = {"idx": n_idx, "coords": n_coords, "corners": corners_n, "found": found_n,
                    "G": _gather_rows(feats, corners_n, leaf=mode != "dense")}
        G = _gather_rows(feats, corners, leaf=mode != "dense")
        for p in dense.values():
            p.grad = None
        if mode == "dense":
            for f in feats:
                f.grad = None

        total, aux = _compute_loss_sparse(params, G, batch, found, s, near)
        if mode == "dense" and s.continual_reg_on:
            reg = _dense_reg(s, shadow, feats, corners)
            total = total + s.lambda_forget * reg
            aux["reg_loss"] = reg
            aux["total_loss"] = total
        total.backward()

        lr = lr_at_step(s.lr, step, s.lr_decay_step, s.lr_iters_reduce_ratio)
        dense_grads = {k: p.grad for k, p in dense.items()}
        if not s.opt_adam:
            # SGD runs the dense update only (JAX _resolve_mode)
            sgd_update(dense, dense_grads, opt_state, lr, lr_scale, wd)
            for i, f in enumerate(feats):
                sgd_leaf(f, f.grad, m_feats[i], lr * lr_scale[FEATURES][i], 0.0)
            return aux
        adam_update(dense, dense_grads, opt_state, lr, lr_scale, wd, b1=0.9, b2=0.99,
                    eps=s.adam_eps)
        bc1, bc2 = bias_corrections(opt_state.step)
        if mode == "dense":
            for i, f in enumerate(feats):
                adam_leaf(f, f.grad, m_feats[i], v_feats[i], lr * lr_scale[FEATURES][i], 0.0,
                          bc1, bc2, eps=s.adam_eps)
            return aux
        grads = [g_i.grad for g_i in G]
        if mode == "sparse":
            reg_total = None
            for i in range(L):
                seg = sparse_adam.segment_by_row(corners[i], grads[i], feats[i].shape[0])
                kw = {}
                if s.continual_reg_on:
                    kw = dict(reg_lambda=s.lambda_forget, importance=shadow["importance"][i],
                              last_frame=shadow["last_frame"][i])
                reg_i = sparse_adam.sparse_adam_level(
                    feats[i], m_feats[i], v_feats[i], seg, lr * lr_scale[FEATURES][i], bc1, bc2,
                    eps=s.adam_eps, **kw)
                reg_total = reg_i if reg_total is None else reg_total + reg_i
            if s.continual_reg_on:
                aux["reg_loss"] = reg_total
                aux["total_loss"] = aux["total_loss"] + s.lambda_forget * reg_total
            return aux
        if s.continual_reg_on:
            if batch_windows is not None:
                owner = [o[wsel] for o in batch_windows.owner]
            else:
                owner = [owner_flags(c, f) for c, f in zip(corners, found)]
            grads, reg = _reg_fold(s, shadow, corners, G, grads, owner)
            aux["reg_loss"] = reg
            aux["total_loss"] = aux["total_loss"] + s.lambda_forget * reg
        if near is not None:
            # the near points' rows ride the update as extra entries
            corners = [torch.cat([c.reshape(-1, 8), cn.reshape(-1, 8)])
                       for c, cn in zip(corners, near["corners"])]
            grads = [torch.cat([g, gn.grad]) for g, gn in zip(grads, near["G"])]
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
            for i in range(L):
                adam_kernel.fused_adam(
                    feats[i], m_feats[i], v_feats[i], corners[i], grads[i],
                    lr * lr_scale[FEATURES][i], bc1, bc2, n_used[i],
                    pre=adam_kernel.window_prep(batch_windows.preps[i], wsel), **kw)
        elif s.fuse_update_levels:
            dropped.add_(adam_kernel.fused_adam_multi(
                feats, m_feats, v_feats, corners, grads, lr, bc1, bc2,
                lr_scale[FEATURES], n_used, **kw))
        else:
            for i in range(L):
                dropped.add_(adam_kernel.fused_adam(
                    feats[i], m_feats[i], v_feats[i], corners[i], grads[i],
                    lr * lr_scale[FEATURES][i], bc1, bc2, n_used[i], **kw))
        return aux

    dropped = torch.zeros((), dtype=torch.int64, device=device)
    hist: List[Dict[str, torch.Tensor]] = []
    if mode == "dense":
        for f in feats:
            f.requires_grad_(True)
    try:
        for it in range(n_iters):
            step = start_iter + it
            aux = one_step(step, it)
            hist.append({k: a.detach() for k, a in aux.items()})
    finally:
        if mode == "dense":
            for f in feats:
                f.requires_grad_(False)
                f.grad = None

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
