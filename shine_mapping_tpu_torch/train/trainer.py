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
   (``ops/adam_kernel.py``), fed with the gathered rows' gradients: K1's
   per-level step (on iid batches one prep and one launch over all levels,
   each level with its lr; on per-level windows one launch a level) or K2
   (one launch over all levels), with the row prep of a window
   precomputed.  The consistency term's near points add their rows and
   gradients to the batch's as extra entries.

JAX runs a chunk as one jitted ``lax.scan``; here it is a Python loop of
torch ops that update the parameters and the optimizer state in place.
Where the call's arguments allow it (:func:`step_graph_ok`: CUDA tables on
one card, iid batches through pool lookups, the kernel update with Adam,
no term that draws or probes more each step), a step runs as one recorded
CUDA graph from the drawn indices through the decoders' Adam: a key's
first step runs eagerly, its second records the graph
(:func:`step_graph_key` is what it bakes in) and replays it, and every
later step replays it; the draw, the tables' update (K1 or K2, with its
prep) and Adam's host bookkeeping stay eager around it, bit for bit the
eager step.  ``GRAPH_COUNTS`` counts the steps each way.  Every other
path runs eagerly.  While tracing is on (``utils.profiling``), the loop and
the aux stacking are the span ``chunk``, each step ``step``, with the
children ``step.forward`` (steps 1-3), ``step.backward`` and
``step.update`` (4-5) on an eager or recording step, and ``step.replay``
(the draw, the replay, the tables' update) on a replayed one.
Both feature-update modes run the same reference dense Adam: on the card
through the CUDA kernel, on the CPU through its plain twin.
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

Several ranks (``train_chunk(..., group=)``, one process a card; JAX's
``batch_sharding``): each rank trains its slice of the global batch and
the tables are updated either on every rank from all ranks' gathered
entries (replicated tables) or by each rank over its row blocks
(row-sharded tables), their entries routed once per routed window
(:class:`RoutedWindows`, :func:`shard_windows_ok`) or live each iid step
(:func:`_live_route`) into K2's row-sharded caller (the lazy, dense and SGD
updates summing the received entries by row).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.decoder import Decoder
from ..ops import adam_kernel
from ..ops.adam_kernel import EntryPrep
from ..ops.hashgrid import LevelTable, lookup_level
from ..ops.interp import corner_weights
from ..utils.profiling import span
from . import losses, sparse_adam
from .optimizer import (
    FEATURES,
    OptState,
    adam_leaf,
    adam_scalars,
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
class RoutedWindows:
    """Per-window entry routing of the row-sharded update (JAX
    ``_route_shard_windows``, trainer.py:1928-2075, on the port's layout).

    With ``n`` ranks, rank s trains samples ``[s bs / n, (s + 1) bs / n)``
    of each window; its local entries are ordered (level, sample, corner),
    ``M_loc = L bs / n 8`` of them.  An entry's row lies in rank d's block
    (``adam_kernel.shard_geometry``).  Only found corners route (a miss's
    weight is zero, its row the zero row, its gradient zero).  Each
    (sample rank s, row rank d, level l) cell holds at most ``E`` entries in
    entry order; pads fill the rest.  Per window:

    * ``serve`` (n_d, n_s, L, E) int32: the block rows rank d gathers for
      rank s's entries (-1 = pad); one all-to-all takes them to the samples;
    * ``recv_inv`` (n_s, M_loc) int32: where rank s finds entry i in its
      received (n_d, L, E) rows (``n L E`` = an appended zero row);
    * ``owner_sel`` (n_s, n_d, L, E) int32: the local entries whose
      gradients rank s sends to rank d (``M_loc`` = an appended zero row);
    * ``pre``: rank d's :func:`~..ops.adam_kernel.entry_prep_local` over the
      (n_s, L, E) gradients it receives (their rows: ``serve`` in the
      blocks concatenated).

    Routed for one rank (``rank`` set: ``precompute_batch_windows(...,
    rank=)`` or ``local_part(rank)``), the arrays lose their rank axis.
    ``sizes``: the whole tables' rows per level."""

    serve: torch.Tensor
    recv_inv: torch.Tensor
    owner_sel: torch.Tensor
    pre: EntryPrep
    n: int
    E: int
    sizes: Tuple[int, ...]
    rank: Optional[int] = None

    def local_part(self, rank: int) -> "RoutedWindows":
        if self.rank is not None:
            raise ValueError("these routed windows are already one rank's")
        p = self.pre
        pre = EntryPrep(p.rows[:, rank].contiguous(), p.order[:, rank].contiguous(),
                        p.tile_off[:, rank].contiguous(), p.dropped[:, rank].contiguous(),
                        p.sizes, p.n_used, p.tb, p.sorted_by_row)
        return RoutedWindows(self.serve[:, rank].contiguous(), self.recv_inv[:, rank].contiguous(),
                             self.owner_sel[:, rank].contiguous(), pre, self.n, self.E,
                             self.sizes, rank)


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
    # the preps are the plain, sorted ones (the replicas' deterministic sum)
    deterministic: bool = False
    # row-sharded routing (shards=n; no global preps then)
    route: Optional[RoutedWindows] = None

    @property
    def n_windows(self) -> int:
        return int(self.idx.shape[0])

    @property
    def built_for(self) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
        """(table rows, used heads) per level that the preps were built for."""
        return (sum((p.sizes for p in self.preps), ()),
                sum((p.n_used for p in self.preps), ()))


def shard_windows_ok(settings: TrainSettings, feat_shapes, n_shards: int) -> bool:
    """Can fused epoch windows route a row-sharded update over ``n_shards``
    ranks (JAX ``shard_windows_ok``, trainer.py:194)?  Two or more shards
    that split the batch and every level's table evenly
    (``adam_kernel.shardable``), and the fused windows' own conditions.
    Unlike the JAX package, any shard count that divides evenly will do
    (its power of two sized the split-K prefix)."""
    n = int(n_shards)
    return (n >= 2 and settings.bs % n == 0 and adam_kernel.shardable(feat_shapes, n)
            and batch_windows_ok(settings, feat_shapes, True))


def _route_cells(rows, found, sizes, n: int):
    """Per entry of W windows ((level, sample, corner) order): its cell
    ``(sample rank, row rank, level)`` (``n n L`` for a miss, which does not
    route), its local index on its sample's rank and its row in its row
    rank's block."""
    W, bs = int(rows[0].shape[0]), int(rows[0].shape[1])
    L = len(sizes)
    b = bs // n
    dev = rows[0].device
    samp = torch.arange(bs, device=dev).repeat_interleave(8).repeat(L)  # (L bs 8,)
    lvl = torch.arange(L, device=dev).repeat_interleave(bs * 8)
    owner = samp // b
    local = lvl * (b * 8) + (samp % b) * 8 + torch.arange(8, device=dev).repeat(L * bs)
    r = torch.cat([rows[l].reshape(W, -1).to(torch.int64) for l in range(L)], dim=1)
    real = torch.cat([found[l].reshape(W, bs, 1).expand(W, bs, 8).reshape(W, -1)
                      for l in range(L)], dim=1)
    cl = torch.tensor([C // n for C in sizes], device=dev)[lvl]  # each entry's block rows
    dest = r // cl
    cell = torch.where(real, (owner * n + dest) * L + lvl, n * n * L)
    return cell, local, r - dest * cl


@torch.no_grad()
def _route_windows(rows, found, sizes, D: int, n: int, rank: Optional[int] = None,
                   chunk: int = 1 << 22) -> RoutedWindows:
    """:class:`RoutedWindows` of W windows: ``rows[l]`` (W, bs, 8) level
    l's corner rows of each window's samples, ``found[l]`` (W, bs).  With
    ``rank``, only that rank's part (the rows it serves, its shard prep, its
    sends and its receive map), so a rank builds and holds 1/n of the
    routing; else every rank's.  Runs ``chunk`` entries' worth of windows at
    a time (two passes: the largest cell of any rank sets E, then the
    routing), so the temporaries stay ~20 bytes an entry of a chunk whatever
    the pool."""
    W, bs = int(rows[0].shape[0]), int(rows[0].shape[1])
    L = len(sizes)
    b = bs // n
    M_loc, n_cells = L * b * 8, n * n * L
    wc = max(1, chunk // (L * bs * 8))
    spans = [(w0, min(w0 + wc, W)) for w0 in range(0, W, wc)]

    def part(w0, w1):
        return ([r[w0:w1] for r in rows], [f[w0:w1] for f in found])

    cmax = 0
    for w0, w1 in spans:
        cell = _route_cells(*part(w0, w1), sizes, n)[0]
        cnt = torch.zeros((w1 - w0, n_cells + 1), dtype=torch.int64, device=cell.device)
        cnt.scatter_add_(1, cell, torch.ones_like(cell))
        cmax = max(cmax, int(cnt[:, :n_cells].max()))
    E = max(8, -(-cmax // 8) * 8)  # at most 8 bs / n: a sample rank's entries of a level
    nle = n * L * E
    off = torch.tensor([sum(C // n for C in sizes[:l]) for l in range(L)],
                       device=rows[0].device).reshape(1, 1, L, 1)
    ranks = range(n) if rank is None else [int(rank)]
    out = {}  # each array whole, filled chunk by chunk (no second copy to concatenate)

    def put(name, w0, t):
        if name not in out:
            out[name] = torch.empty((W,) + tuple(t.shape[1:]), dtype=t.dtype, device=t.device)
        out[name][w0:w0 + t.shape[0]] = t

    fields = ("rows", "order", "tile_off", "dropped")
    for w0, w1 in spans:
        cell, local, lrow = _route_cells(*part(w0, w1), sizes, n)
        Wc, dev = w1 - w0, cell.device
        cs, perm = torch.sort(cell, dim=1, stable=True)
        rank_in = torch.arange(cs.shape[1], device=dev) - torch.searchsorted(cs, cs)
        valid = cs < n_cells
        src = torch.div(cs, n * L, rounding_mode="floor")  # the sample rank
        dst = torch.div(cs, L, rounding_mode="floor") % n  # the row rank
        lvl = cs % L
        loc_s, row_s = local[perm], torch.gather(lrow, 1, perm)
        del cell, local, lrow, cs, perm
        part_r = {k: [] for k in ("serve", "recv_inv", "owner_sel", "pre")}
        for r in ranks:
            # rank r as the row rank: the block rows it serves each sample
            # rank, (n_s, L, E), and its shard prep over the gradients back
            to_r = valid & (dst == r)
            slot = torch.where(to_r, (src * L + lvl) * E + rank_in, nle)
            serve = torch.full((Wc, nle + 1), -1, dtype=torch.int64, device=dev)
            serve = serve.scatter_(1, slot, row_s)[:, :-1].reshape(Wc, n, L, E)
            rows_recv = torch.where(serve >= 0, serve + off, -1).reshape(Wc, nle)
            part_r["pre"].append(adam_kernel.entry_prep_local(rows_recv, [C // n for C in sizes],
                                                              D))
            part_r["serve"].append(serve.to(torch.int32))
            # rank r as the sample rank: the local entries it sends each row
            # rank, (n_d, L, E), and where it finds each entry's received row
            from_r = valid & (src == r)
            slot = torch.where(from_r, (dst * L + lvl) * E + rank_in, nle)
            sel = torch.full((Wc, nle + 1), M_loc, dtype=torch.int64, device=dev)
            part_r["owner_sel"].append(sel.scatter_(1, slot, loc_s)[:, :-1]
                                       .reshape(Wc, n, L, E).to(torch.int32))
            ri = torch.full((Wc, M_loc + 1), nle, dtype=torch.int64, device=dev)
            part_r["recv_inv"].append(ri.scatter_(1, torch.where(from_r, loc_s, M_loc), slot)
                                      [:, :-1].to(torch.int32))
            del to_r, from_r, slot, serve, rows_recv, sel, ri
        for k in ("serve", "recv_inv", "owner_sel"):  # a rank axis after the window's
            put(k, w0, torch.stack(part_r[k], 1) if rank is None else part_r[k][0])
        for f in fields:
            ts = [getattr(p, f) for p in part_r["pre"]]
            put(f, w0, torch.stack(ts, 1) if rank is None else ts[0])
        prep_meta = part_r["pre"][0][4:]
        del src, dst, lvl, valid, rank_in, loc_s, row_s, part_r
    pre = EntryPrep(*(out[f] for f in fields), *prep_meta)
    return RoutedWindows(out["serve"], out["recv_inv"], out["owner_sel"], pre, n, E,
                         tuple(sizes), rank)


@torch.no_grad()
def precompute_batch_windows(pre_lookups, n_valid: int,
                             generator: Optional[torch.Generator],
                             settings: TrainSettings, feat_shapes, fused: bool = True,
                             window_indices: Optional[torch.Tensor] = None,
                             reg_cover: bool = False, shards: int = 0,
                             rank: Optional[int] = None,
                             deterministic: bool = False) -> BatchWindows:
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

    ``shards`` (n >= 2, fused only): route the windows for a row-sharded
    update over n ranks (:class:`RoutedWindows`, the JAX package's
    ``shards`` branches, trainer.py:2081-2395) instead of one global prep;
    ``feat_shapes`` are the whole tables'.  ``rank`` routes only that
    rank's part (1/n of the routing's work and bytes; what a training rank
    passes), else every rank's, of which ``parallel.mesh.
    place_routed_windows`` keeps one.  ``deterministic``
    builds the preps with the plain, sorted prep on any device (what the
    kernel's deterministic sum needs: the data-parallel replicas).

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
    if shards:
        if not (fused and shard_windows_ok(s, feat_shapes, shards)):
            raise ValueError(f"routed windows need the fused layout and tables and a batch "
                             f"that split evenly over {shards} shards (shard_windows_ok)")
        if reg_cover:
            raise ValueError("continual_reg_on is not supported with routed windows (as in "
                             "the JAX package): use replicated tables")
        found = [pre_lookups[i][1][idx] for i in range(len(sizes))]
        route = _route_windows(rows, found, sizes, D, int(shards), rank)
        return BatchWindows(idx=idx, fused=True, preps=[], route=route)
    stack = ((lambda r, c, nu, d: adam_kernel.entry_prep_stack_plain(
        r, c, nu, adam_kernel.tile_rows(d))) if deterministic else adam_kernel.entry_prep_stack)
    if fused:
        preps = [stack(rows, sizes, n_used, D)]
    else:
        preps = [stack([r], [C], [nu], int(sh[1]))
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
    return BatchWindows(idx=idx, fused=fused, preps=preps, owner=owner,
                        deterministic=deterministic)


def estimate_windows_bytes(n_valid: int, settings: TrainSettings, feat_shapes,
                           reg_cover: bool = False, shards: int = 0) -> int:
    """Device bytes :func:`precompute_batch_windows` holds for a run (JAX
    ``estimate_windows_bytes``, trainer.py:1807, on the port's layout): per
    window the int64 indices and, per entry (bs x 8 corners x L levels),
    an int32 row and an int32 order (and with ``reg_cover`` a bool owner
    flag), plus per prep an int64 dropped count, an int32 offset per tile
    of the update kernel and one more, and the kernel's work list
    (``feat_shapes``: the tables' (C_l, D)).  Counted for the per-level
    layout, whose L preps hold L - 1 tile offsets and work-list bounds more
    than the fused one.  ``shards``: one rank's share of
    routed windows over that many ranks."""
    s = settings
    W = max(-(int(n_valid) // -s.bs), 1)
    L = len(s.levels)
    sizes = [int(C) for C, _ in feat_shapes]
    n_used = list(s.n_used) if s.n_used is not None else sizes
    tiles = sum(-(-nu // adam_kernel.tile_rows(D)) for nu, (_, D) in zip(n_used, feat_shapes))
    if shards:
        # one rank's routed windows: the indices, and per (other rank,
        # level) cell of E slots the served row, the send selection and the
        # shard prep's row and order, the receive map per local entry, the
        # shard's tile offsets (JAX places them at 1/n a chip,
        # parallel/mesh.py:111-145).  E at its most, 8 bs / n: under the
        # contiguous row split one row rank may take all of a level's entries
        n = int(shards)
        E = 8 * (s.bs // n)
        tiles_loc = sum(-(-(C // n) // adam_kernel.tile_rows(D)) for C, D in feat_shapes)
        return W * (8 * s.bs + 4 * 4 * n * L * E + 4 * L * (s.bs // n) * 8
                    + 4 * (tiles_loc + 1) + 8)
    per_entry = 8 + (1 if reg_cover else 0)
    # per prep also the update's work list: a first extra item per tile, and
    # (tile, chunk) pairs for at most M / ENTRY_CHUNK + 1 items and their count
    work = 4 * tiles + L * (8 * (8 * s.bs // adam_kernel.ENTRY_CHUNK + 1) + 4)
    return W * (8 * s.bs + per_entry * s.bs * 8 * L + 8 * L + 4 * (tiles + L) + work)


def owner_flags(corners: torch.Tensor, found: torch.Tensor) -> torch.Tensor:
    """Which gradient entries carry the continual-learning reg: of a batch's
    corner rows ``corners`` (..., B, 8) and found masks ``found`` (..., B),
    the first (sample, corner), in sample-major order, of each row that a
    found sample touches (a stable sort over the batch's ``B * 8`` entries;
    JAX's cover masks choose the same owner, trainer.py:2250-2262).
    Returns (..., B, 8) bool; misses own nothing, so the trashbin row
    takes no reg."""
    lead = corners.shape[:-2]
    rows = torch.where(found[..., None], corners.to(torch.int64), -1).reshape(*lead, -1)
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


def _compute_loss_sparse(params, G_list, batch, found, s: TrainSettings, near=None,
                         counts=None):
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
    projective correction's cosine included).  ``counts`` (a rank's share
    of a data-parallel batch): each term's global denominator (``n``
    samples, ``n_rays``, ``n_surf`` surface samples, ``n_near`` near
    points, ``n_sem`` labels), so the ranks' terms sum to the whole batch's.
    Returns (total, aux)."""
    c = counts or {}
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
            depth_ray, pred_ray, batch["ray_depth"], neus_on=(s.main_loss_type == "dr_neus"),
            count=c.get("n_rays"))
    else:
        w = torch.abs(weight)
        if s.main_loss_type == "sdf_bce":
            if counts is not None and s.loss_reduction == "mean":
                sdf_loss = losses.sdf_bce_loss(
                    pred, target, s.sigma_sigmoid, w, s.loss_weight_on, "sum") / c["n"]
            else:
                sdf_loss = losses.sdf_bce_loss(
                    pred, target, s.sigma_sigmoid, w, s.loss_weight_on, s.loss_reduction)
        elif s.main_loss_type == "sdf_l1":
            sdf_loss = losses.sdf_diff_loss(pred, target, w, s.scale, False, c.get("n"))
        elif s.main_loss_type == "sdf_l2":
            sdf_loss = losses.sdf_diff_loss(pred, target, w, s.scale, True, c.get("n"))
        else:
            raise ValueError(f"unknown main_loss_type {s.main_loss_type}")
    total = sdf_loss
    aux["sdf_loss"] = sdf_loss
    if s.ekional_loss_on:
        ek = losses.eikonal_loss(g, surface_mask, c.get("n_surf"))
        total = total + s.weight_e * ek
        aux["eikonal_loss"] = ek
    if s.consistency_loss_on:
        # gradient agreement between jittered nearby points
        # (shine_batch.py:149-158, 187-190)
        cn = near["coords"].detach().requires_grad_(True)
        fn = feat_from_rows(cn, near["G"], near["found"], s.levels, s.poly_int_on)
        ts_n = batch["ts"][near["idx"]] if s.time_conditioned else None
        (gn,) = torch.autograd.grad(pred_of(fn, ts_n).sum(), cn, create_graph=True)
        cons = losses.consistency_loss(g[near["idx"]], gn * s.sigma_sigmoid, c.get("n_near"))
        total = total + s.weight_c * cons
        aux["consistency_loss"] = cons
    if s.normal_loss_on:
        nl = losses.normal_loss(g, batch["normal_label"], surface_mask, c.get("n_surf"))
        total = total + s.weight_n * nl
        aux["normal_loss"] = nl
    if s.semantic_on:
        sem_pred = params["sem"].sem_label_prob(feat)
        d = s.sem_label_decimation
        sl = losses.sem_nll_loss(sem_pred[::d], batch["sem_label"][::d], c.get("n_sem"))
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


def _lookups(tables, feats, coords, levels: Sequence[int], sizes=None):
    """Per level: the containing node's corner rows (misses -> the trashbin
    row; a missed probe lands on an arbitrary slot whose rows may belong to
    a real node) and the found mask.  ``sizes``: the whole tables' rows
    (row-sharded ``feats`` hold blocks); default ``feats``' own."""
    corners, found = [], []
    with torch.no_grad():
        for i, level in enumerate(levels):
            c_i, f_i = lookup_level(tables[i], coords, level)
            C = feats[i].shape[0] if sizes is None else sizes[i]
            trash = torch.full_like(c_i, C - 1)
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


# train_chunk's steps by how they ran: eagerly, recorded as a CUDA graph,
# replayed from one (a recording step also replays)
GRAPH_COUNTS = {"eager": 0, "captured": 0, "replayed": 0}


def reset_graph_counts() -> None:
    for k in GRAPH_COUNTS:
        GRAPH_COUNTS[k] = 0


def step_graph_ok(settings: TrainSettings, device, group=None, pre_lookups=None,
                  batch_windows=None, batch_indices=None) -> bool:
    """Whether :func:`train_chunk`'s iid steps run as one recorded CUDA
    graph: CUDA tables on one card (no ``group``), batches drawn from the
    generator (no windows, no ``batch_indices``) and gathered through
    ``pre_lookups``, the kernel update on the tables (K1's per-level step,
    or K2 under ``fuse_update_levels``) with Adam, and none of the terms
    that draw or probe more each step (consistency, ray loss) or read the
    shadow tables (the continual reg)."""
    s = settings
    return (torch.device(device).type == "cuda" and group is None and batch_windows is None
            and batch_indices is None and pre_lookups is not None and s.opt_adam
            and resolve_feature_update(s) in ("fused", "pallas")
            and not (s.consistency_loss_on or s.continual_reg_on or s.ray_loss))


def _signature(t: torch.Tensor):
    return (t.data_ptr(), tuple(t.shape), t.stride(), t.dtype, str(t.device))


def step_graph_key(params, opt_state: OptState, pool, pre_lookups, settings: TrainSettings,
                   n_valid: int, zero_lr=frozenset()):
    """What a recorded step reads and bakes in: the address, shape, strides
    and dtype of every tensor it reads or writes (the decoders, tables and
    their moments, the pool, the pool's lookups), the settings, ``n_valid``
    and, last, the dense leaves whose lr scale is 0 (``zero_lr``, the frozen
    decoders: the update leaves them out).  A step whose key differs records anew."""
    dense = dense_params(params)
    ts = list(dense.values()) + list(params[FEATURES])
    for st in (opt_state.m, opt_state.v):
        ts += [st[k] for k in dense] + list(st[FEATURES])
    ts += [pool[k] for k in sorted(pool)] + [t for pair in pre_lookups for t in pair]
    return (settings, int(n_valid), tuple(dense), tuple(sorted(pool)),
            tuple(_signature(t) for t in ts), frozenset(zero_lr))


def _record_graph(body):
    """``body`` recorded once as a CUDA graph (its device work does not run
    then); returns the graph's replay.  cuBLAS keeps a workspace for each
    stream it runs on: cleared before and after the recording (as torch's
    own graph trees do), the recording stream's, which lives in the graph's
    pool, is the one workspace while it records, and the eager steps' is made
    anew afterwards, so that the recording adds none to the peak.  Only this
    thread's calls are checked while it records (``thread_local``): another
    thread's copies (the batch CLI uploads the next sub-pool on one) go on."""
    graph = torch.cuda.CUDAGraph()
    torch._C._cuda_clearCublasWorkspaces()
    try:
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            body()
    finally:
        torch._C._cuda_clearCublasWorkspaces()
    return graph.replay


class _StepGraph:
    """One key's recorded iid step (:func:`train_chunk`): the static inputs
    it reads (the drawn indices, the step's Adam numbers) and the outputs it
    leaves (the batch's corner rows and their gradients for the table
    update, the aux stacked in ``aux_keys`` order).  ``replay`` is None until
    the key's second step records it; the first runs eagerly."""

    __slots__ = ("key", "replay", "draw", "scalars", "corners", "grads", "aux_keys", "aux")

    def __init__(self, key):
        self.key = key
        self.replay = None


def _check_supported(s: TrainSettings, mode: str, group, batch_windows) -> bool:
    """Raise ValueError for what the JAX package refuses over several ranks
    too.  Returns whether the chunk runs over several ranks."""
    if group is None or group.world == 1:
        if batch_windows is not None and batch_windows.route is not None:
            raise ValueError("routed windows need the group of ranks they were routed for")
        return False
    routed = batch_windows is not None and batch_windows.route is not None
    rows = group.table_sharding == "rows"
    if rows and not routed and mode == "pallas":
        # JAX trainer.py:806-820: its kernel island runs replicated and
        # would all-gather row-sharded tables into every chip each step
        raise ValueError("feature_update 'pallas' needs replicated feature tables; with "
                         "tpu.table_sharding: rows use 'fused'/'sparse' or precompute the "
                         "windows with shards=n_devices")
    if not rows and routed:
        raise ValueError("routed windows update row-sharded tables: place the training "
                         "state with table_sharding 'rows'")
    if routed:
        rt = batch_windows.route
        if rt.rank != group.rank or rt.n != group.world:
            raise ValueError(f"routed windows of rank {rt.rank} of {rt.n}, not {group.rank} of "
                             f"{group.world}: place them with place_routed_windows")
    if s.continual_reg_on and routed:
        raise ValueError("continual_reg_on is not supported with shard-routed windows; "
                         "use replicated tables (as the JAX package)")
    if s.bs % group.world:
        raise ValueError(f"bs {s.bs} does not split over {group.world} ranks")
    if s.semantic_on and (s.bs // group.world * (s.ray_sample_count if s.ray_loss else 1)
                          ) % s.sem_label_decimation:
        raise ValueError("each rank's batch must be a whole number of sem_label_decimation "
                         "strides")
    if (batch_windows is not None and not routed and not rows and mode in ("fused", "pallas")
            and not batch_windows.deterministic):
        raise ValueError("replicated ranks need windows with sorted preps for the update's "
                         "deterministic sum: precompute_batch_windows(..., deterministic=True)")
    return True


def _check_modes(s: TrainSettings, mode, feats, m_feats, n_used, pool, pre_lookups,
                 batch_windows, batch_indices, sr_noise16, n_iters, shadow,
                 generator, near_indices, near_shifts, routed_group=None) -> None:
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
        if routed_group is not None:
            want = tuple(C // routed_group.world for C in batch_windows.route.sizes)
            if tuple(sh[0] for sh in shapes) != want:
                raise ValueError(f"routed windows were built for blocks of {want} rows, the "
                                 f"tables have {tuple(sh[0] for sh in shapes)}")
        elif batch_windows.built_for != (tuple(sh[0] for sh in shapes), tuple(n_used)):
            built = batch_windows.built_for
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


def _near_points(s: TrainSettings, coords, it, generator, near_indices, near_shifts,
                 B: Optional[int] = None, lo: int = 0):
    """The consistency term's jittered near points of one step: ``cnt =
    min(consistency_count, B)`` batch samples (uniform, with replacement)
    shifted by U(-r, r) per axis, r = ``consistency_range * scale`` (JAX
    body_fused, trainer.py:1190-1198), or the given draws.  ``B``, ``lo``:
    the whole batch's size and the first sample of ``coords`` in it (a
    rank's share): the draws are the whole batch's, and the points whose
    source sample lies in the share are kept.  Returns (source indices in
    ``coords``, near coords)."""
    B = coords.shape[0] if B is None else B
    if near_indices is not None:
        idx = near_indices[it].to(device=coords.device, dtype=torch.int64)
        shift = near_shifts[it].to(device=coords.device, dtype=coords.dtype)
    else:
        cnt = min(s.consistency_count, B)
        r = s.consistency_range * s.scale
        idx = torch.randint(0, B, (cnt,), generator=generator, device=coords.device)
        shift = (torch.rand((cnt, 3), generator=generator, device=coords.device)
                 * (2 * r) - r).to(coords.dtype)
    if B != coords.shape[0]:
        keep = (idx >= lo) & (idx < lo + coords.shape[0])
        idx, shift = idx[keep] - lo, shift[keep]
    return idx, coords[idx] + shift


def _sum_rows(group, rows: torch.Tensor, sums: torch.Tensor):
    """The ranks' per-row sums added up (the lazy and dense updates'
    compact all-reduce): ``rows`` (S,) int64 unique rows of this rank,
    ``sums`` (S, D).  Every rank gets the same (unique rows, sums), each
    row's parts added in rank order."""
    from ..parallel import comm

    D = sums.shape[1]
    n = comm.all_gather(group, torch.tensor([rows.shape[0]], device=rows.device))
    S = int(n.max())
    pad_r = torch.full((S,), -1, dtype=torch.int64, device=rows.device)
    pad_r[: rows.shape[0]] = rows
    pad_g = torch.zeros((S, D), dtype=torch.float32, device=rows.device)
    pad_g[: rows.shape[0]] = sums
    all_r = comm.all_gather(group, pad_r).reshape(-1)
    all_g = comm.all_gather(group, pad_g).reshape(-1, D)
    rank_of = torch.arange(group.world, device=rows.device).repeat_interleave(S)
    ok = all_r >= 0
    u, inv = torch.unique(all_r[ok], sorted=True, return_inverse=True)
    parts = torch.zeros((u.shape[0], group.world, D), dtype=torch.float32, device=rows.device)
    parts[inv, rank_of[ok]] = all_g[ok]  # one (row, rank) pair per entry
    total = parts[:, 0].clone()
    for k in range(1, group.world):
        total += parts[:, k]
    return u, total


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


class _LiveRoute(NamedTuple):
    """One iid step's entries routed to their rows' ranks (:func:`_live_route`)."""

    slot: torch.Tensor  # (M,) each entry's place in the (n, L, E) cells; n L E: not routed
    counts: torch.Tensor  # (n_s, n_d, L, 2): entries rank s sends rank d, of them the batch's
    E: int
    req: torch.Tensor  # (n_s, L, E) int64: the block rows each rank asked of this one, -1 pad


def _live_route(group, rows_l, go_l, sizes, n_batch) -> _LiveRoute:
    """The live routing of an iid step on row-sharded tables (the
    counterpart of :class:`RoutedWindows`, built per step).  ``rows_l[l]``
    (M_l,) level l's entries' rows in the whole table, ``go_l[l]`` (M_l,)
    which of them route (one that does not reads the zero row and sends no
    gradient), of which the first ``n_batch[l]`` are the batch's (the
    rest the consistency term's near points).  Each goes to its row's rank
    ``r // (C_l / n)`` (as :func:`_route_cells`), into the cell (row rank,
    level), in entry order, so a cell's entries from one rank arrive in
    (sample, corner) order, the batch's first.  The cells are padded to
    the step's largest (``comm.uneven_block``: one gather of the counts,
    one host read), and one all-to-all takes each rank its requests."""
    from ..parallel import comm

    n, L = group.world, len(sizes)
    dev = rows_l[0].device
    cells, lrows, in_b = [], [], []
    for l, (r, go, C) in enumerate(zip(rows_l, go_l, sizes)):
        cl = int(C) // n
        r = r.reshape(-1).to(torch.int64)
        d = torch.div(r, cl, rounding_mode="floor")
        cells.append(torch.where(go.reshape(-1), d * L + l, n * L))
        lrows.append(r - d * cl)
        in_b.append(torch.arange(r.shape[0], device=dev) < int(n_batch[l]))
    cell, lrow, in_b = torch.cat(cells), torch.cat(lrows), torch.cat(in_b)
    cnt = torch.zeros((2, n * L + 1), dtype=torch.int64, device=dev)
    cnt[0].scatter_add_(0, cell, torch.ones_like(cell))
    cnt[1].scatter_add_(0, cell, in_b.to(torch.int64))
    every, E = comm.uneven_block(group, cnt[:, :n * L].reshape(2, n, L).permute(1, 2, 0))
    srt, perm = torch.sort(cell, stable=True)
    pos = torch.arange(srt.shape[0], device=dev) - torch.searchsorted(srt, srt)
    slot = torch.empty_like(srt).scatter_(0, perm, torch.where(srt < n * L, srt * E + pos,
                                                               n * L * E))
    send = torch.full((n * L * E + 1,), -1, dtype=torch.int32, device=dev)
    send.index_put_((slot,), torch.where(cell < n * L, lrow, -1).to(torch.int32))
    req = comm.all_to_all(group, send[:-1].reshape(n, L, E)).long()
    return _LiveRoute(slot, every, E, req)


def _live_serve(group, rt: _LiveRoute, feats) -> torch.Tensor:
    """Island 1 of a live routing: the rows of this rank's blocks go back to
    the ranks that asked.  Returns each entry's row, (M, D) float32 (the
    zero row for an entry that does not route)."""
    from ..parallel import comm

    D = int(feats[0].shape[1])
    req = rt.req.clamp(min=0)
    send = torch.stack([feats[l][req[:, l]] for l in range(len(feats))], dim=1)
    recv = comm.all_to_all(group, send)  # (n_d, L, E, D)
    flat = torch.cat([recv.reshape(-1, D), recv.new_zeros((1, D))])
    return flat[rt.slot].float()


def _live_send(group, rt: _LiveRoute, vals: torch.Tensor) -> torch.Tensor:
    """Island 2 of a live routing: each entry's ``vals`` (M, K) row goes to
    its row's rank.  Returns what this rank receives, (n_s, L, E, K), zero
    in the pads."""
    from ..parallel import comm

    n, L = rt.req.shape[0], rt.req.shape[1]
    buf = vals.new_zeros((n * L * rt.E + 1, vals.shape[1]))
    buf.index_put_((rt.slot,), vals)  # entries that do not route land on the last row
    return comm.all_to_all(group, buf[:-1].reshape(n, L, rt.E, -1))


def _received_batch(rt: _LiveRoute, rank: int):
    """Per level, which entries a row's rank received in a live routing are
    the batch's (the rest the consistency term's near points, or pads).
    Returns per level (n_s, E) bool."""
    slot = torch.arange(rt.E, device=rt.req.device)[None, :]
    return [(slot < rt.counts[:, rank, l, 1][:, None]) & (rt.req[:, l] >= 0)
            for l in range(rt.req.shape[1])]


def _owner_flags_received(rt: _LiveRoute, rank: int):
    """Per level, which entries a row's rank received in a live routing carry
    the continual reg: the received batch entries in global (sample rank,
    local entry) order are the whole batch's (sample, corner) order, so the
    first of each row is one rank's owner entry (:func:`owner_flags`).
    Returns per level (n_s, E) bool."""
    return [owner_flags(rt.req[:, l].reshape(-1, 1), b.reshape(-1)).reshape(b.shape)
            for l, b in enumerate(_received_batch(rt, rank))]


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
    group=None,
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

    ``group`` (:class:`~..parallel.mesh.DataGroup` of two or more ranks,
    the JAX package's ``batch_sharding``): every rank draws the same global
    batch (same generator state, windows or seams) and trains its slice
    ``group.batch_slice(bs)``, so the ranks' slices make up the one-card
    batch; each loss term divides by the whole batch's count and the
    decoders' gradients are summed across ranks (``parallel.comm``).  The
    tables' update follows ``group.table_sharding``:

    * ``replicated``, kernel: every rank gathers all ranks' entries (rows and
      gradients, bf16 when the kernel rounds them so) and runs K1/K2 on
      them with the deterministic sum, so the replicas stay bit-identical
      (JAX's update islands, trainer.py:1282-1330, :1623-1660); windows
      need ``precompute_batch_windows(..., deterministic=True)``;
    * ``replicated``, ``sparse`` / ``dense``: the touched rows' gradients
      are summed across ranks (:func:`_sum_rows`) and every rank steps;
    * ``rows`` with routed windows (``precompute_batch_windows(...,
      shards=n)`` placed by ``parallel.mesh.place_routed_windows``): each
      rank gathers the rows it serves and one all-to-all brings the
      samples' ranks their rows; after the backward a second all-to-all
      takes each entry's gradient to its row's rank, which runs
      ``adam_kernel.fused_adam_shard`` over its blocks (JAX ``body_winx``'s
      islands, trainer.py:1473-1515, :1572-1622);
    * ``rows`` on iid batches (JAX's GSPMD ``rows`` x ``fused`` / ``sparse``,
      trainer.py:806-820): the same two islands routed live each step
      (:func:`_live_route`; ``fused``, the rows' ranks prepping their
      received entries with csrc/entry_prep.cu; ``sparse``, ``dense``
      and SGD summing them by row before they step their blocks);
      ``pallas``, bf16 moments and bf16 tables need routed windows there,
      as in JAX (ValueError).

    The continual reg over ranks: replicated tables fold it into each
    rank's entries with its slice of the whole batch's owner flags (from
    the windows, or from every rank's gathered rows), before the gather;
    row-sharded tables on the rows' ranks (``reg_loss`` the ranks' shares
    added); the lazy and dense updates of replicated tables on the rows
    summed across ranks (rank 0's ``reg_loss`` counted).

    The returned aux are the whole batch's on every rank (one sum across
    ranks per chunk).

    Returns (params, opt_state, {"mean": aux means, "last": last aux}), the
    aux values 0-dim tensors on the device.

    Raises ValueError at the end of the chunk if gradient entries of iid
    batches fell past the ``settings.n_used`` heads (a stale hint; windows
    check this before training).  The steps have then already been applied
    in place without those entries: the tables and moments are not the
    reference's and should be discarded.
    """
    from ..parallel import comm

    s = settings
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
    dp = _check_supported(s, mode, group, batch_windows)
    routed = dp and batch_windows is not None and batch_windows.route is not None
    # row-sharded tables on iid batches: the entries route live, each step
    live = dp and not routed and group.table_sharding == "rows"
    # the dense update by autodiff through whole tables (live routing sums
    # its routed entries instead)
    autodiff = mode == "dense" and not live
    _check_modes(s, mode, feats, m_feats, n_used, pool, pre_lookups, batch_windows,
                 batch_indices, sr_noise16, n_iters, shadow, generator, near_indices,
                 near_shifts, group if routed else None)
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
    D = int(feats[0].shape[1])
    row_base = None
    sizes = [int(f.shape[0]) for f in feats]  # the whole tables' rows
    if routed:
        sizes = list(batch_windows.route.sizes)
    elif live:
        sizes = [int(f.shape[0]) * group.world for f in feats]
    if routed or live:
        row_base = adam_kernel.shard_row_base([(C, D) for C in sizes], group.world, group.rank)
    blocks = [C // group.world for C in sizes] if live else None

    def routed_rows(wsel):
        """Island 1: the rows this rank serves go to their samples' ranks;
        returns this rank's entries' rows G_i (b, 8, D), leaf tensors."""
        rt = batch_windows.route
        srv = rt.serve[wsel].long()  # (n_s, L, E)
        send = torch.stack([feats[l][srv[:, l].clamp(min=0)] for l in range(L)], dim=1)
        recv = comm.all_to_all(group, send)  # (n_d, L, E, D)
        flat = torch.cat([recv.reshape(-1, D), recv.new_zeros((1, D))])
        G_all = flat[rt.recv_inv[wsel].long()].float().reshape(L, -1, 8, D)
        G = [G_all[l].contiguous() for l in range(L)]
        for g_i in G:
            g_i.requires_grad_()
        return G

    def routed_update(wsel, grads, lr, bc1, bc2, step):
        """Island 2: each entry's gradient goes to its row's rank, which
        steps its blocks with K2's row-sharded caller."""
        rt = batch_windows.route
        gflat = torch.cat([g.reshape(-1, D) for g in grads] + [grads[0].new_zeros((1, D))])
        send = gflat[rt.owner_sel[wsel].long()]  # (n_d, L, E, D)
        if grads_bf16:  # the kernel rounds the entries to bf16: ship them so
            send = send.to(torch.bfloat16)
        recv = comm.all_to_all(group, send).reshape(-1, D).float()
        adam_kernel.fused_adam_shard(
            feats, m_feats, v_feats, None, recv, lr, bc1, bc2, lr_scale[FEATURES], row_base,
            eps=s.adam_eps, grads_bf16=grads_bf16, sr_seed=step if params_bf16 else None,
            pre=adam_kernel.window_prep(rt.pre, wsel))

    def live_rows(corners, found, near):
        """Island 1 of an iid step on row-sharded tables: this rank's
        entries (its samples' corners, then its near points') route to
        their rows' ranks (:func:`_live_route`), which serve the rows back.
        The dense update's misses route too: the reg touches their trashbin
        row, as one rank's autodiff does.  Returns (the route, the samples'
        rows G_i (b, 8, D) and the near points' rows, leaf tensors)."""
        rows_l, go_l, n_b = [], [], []
        for i in range(L):
            r, f = [corners[i].reshape(-1)], [found[i][:, None].expand(-1, 8).reshape(-1)]
            if near is not None:
                r.append(near["corners"][i].reshape(-1))
                f.append(near["found"][i][:, None].expand(-1, 8).reshape(-1))
            rows_l.append(torch.cat(r))
            go_l.append(torch.ones_like(rows_l[-1], dtype=torch.bool) if mode == "dense"
                        else torch.cat(f))
            n_b.append(int(corners[i].numel()))
        rt = _live_route(group, rows_l, go_l, sizes, n_b)
        G_all = _live_serve(group, rt, feats)
        G, G_near, o = [], [], 0
        for i in range(L):
            k = rows_l[i].shape[0]
            part = G_all[o:o + k]
            G.append(part[:n_b[i]].reshape(-1, 8, D).contiguous().requires_grad_())
            G_near.append(part[n_b[i]:].reshape(-1, 8, D).contiguous().requires_grad_())
            o += k
        return rt, G, G_near

    def live_update(rt, G, near, lr, bc1, bc2, aux):
        """Island 2 of an iid step on row-sharded tables: every entry's
        gradient goes to its row's rank.  The kernel update folds the
        continual reg into one received entry per touched row (the first of
        the batch's in global (sample, corner) order, as one rank's
        :func:`owner_flags`), preps the received rows with
        ``adam_kernel.entry_prep_shard`` (csrc/entry_prep.cu) and steps its
        blocks with K2's row-sharded caller, also under
        ``fuse_update_levels: false`` (one launch over the levels' blocks).
        The lazy, dense and SGD updates sum the received entries by row and
        step their blocks."""
        grads = [torch.cat([G[i].grad.reshape(-1, D)]
                           + ([near[i].grad.reshape(-1, D)] if near is not None else []))
                 for i in range(L)]
        recv = _live_send(group, rt, torch.cat(grads))  # (n_s, L, E, D)
        reg = None
        if mode in ("fused", "pallas"):
            if s.continual_reg_on:
                rc = rt.req.clamp(min=0)
                g_l, reg = _reg_fold(s, shadow, [rc[:, l] for l in range(L)],
                                     [feats[l][rc[:, l]].float() for l in range(L)],
                                     [recv[:, l] for l in range(L)],
                                     _owner_flags_received(rt, group.rank))
                recv = torch.stack(g_l, dim=1)
            g_loc = recv.permute(1, 0, 2, 3).reshape(-1, D).contiguous()
            req = rt.req.permute(1, 0, 2)  # (L, n_s, E)
            pre = adam_kernel.entry_prep_shard([req[i].contiguous() for i in range(L)],
                                               blocks, D)
            adam_kernel.fused_adam_shard(feats, m_feats, v_feats, None, g_loc, lr, bc1, bc2,
                                         lr_scale[FEATURES], row_base, eps=s.adam_eps,
                                         pre=pre)
        else:
            in_b = _received_batch(rt, group.rank)
            segs = []
            for i in range(L):
                vals = recv[:, i].reshape(-1, D)
                if mode == "dense" and s.continual_reg_on:
                    # a last column marks the rows the samples touch (the reg's)
                    vals = torch.cat([vals, in_b[i].reshape(-1, 1).to(vals.dtype)], dim=1)
                # the pads' row -1 left out (the lazy step's misses do not route)
                segs.append(sparse_adam.segment_by_row(rt.req[:, i], vals, 0))
            if mode == "sparse":
                for i, seg in enumerate(segs):
                    kw = {}
                    if s.continual_reg_on:
                        kw = dict(reg_lambda=s.lambda_forget, importance=shadow["importance"][i],
                                  last_frame=shadow["last_frame"][i])
                    r_i = sparse_adam.sparse_adam_level(
                        feats[i], m_feats[i], v_feats[i], seg, lr * lr_scale[FEATURES][i],
                        bc1, bc2, eps=s.adam_eps, **kw)
                    reg = r_i if reg is None else reg + r_i
            else:
                g_rows, reg = reg_rows([g.rows for g in segs], [g.grads for g in segs])
                for i, (seg, f) in enumerate(zip(segs, feats)):
                    g = torch.zeros(f.shape, dtype=torch.float32, device=device)
                    g.index_put_((seg.rows,), g_rows[i])
                    lr_i = lr * lr_scale[FEATURES][i]
                    if s.opt_adam:
                        adam_leaf(f, g, m_feats[i], v_feats[i], lr_i, 0.0, bc1, bc2,
                                  eps=s.adam_eps)
                    else:
                        sgd_leaf(f, g, m_feats[i], lr_i, 0.0)
        if s.continual_reg_on:
            # this rank's blocks' share: the chunk's sum across ranks adds them
            aux["reg_loss"] = reg
            aux["total_loss"] = aux["total_loss"] + s.lambda_forget * reg

    def reg_rows(rows_l, tot_l):
        """The dense update's touched rows' summed gradients, ``tot_l[l]``'s
        first D columns; under the continual reg with ``2 lambda imp (p -
        last)`` added on the samples' rows (a last column of ``tot_l[l]``
        marks them: :func:`_dense_reg`'s rows).  Returns (the gradients per
        level, the reg or None)."""
        g_rows = [t[:, :D] for t in tot_l]
        if not s.continual_reg_on:
            return g_rows, None
        return _reg_fold(s, shadow, rows_l, [f.detach()[r].float() for f, r in zip(feats, rows_l)],
                         g_rows, [t[:, D] > 0 for t in tot_l])

    def gathered_rows(corners, near):
        """The replicated island's rows: every rank's per level, in rank
        order, (n, L, M_loc) (each rank's near points padded to the batch's
        count with trashbin rows)."""
        rows_l = []
        for i in range(L):
            r = corners[i].reshape(-1).to(torch.int32)
            if near is not None:
                k = near["corners"][i].shape[0]
                pad_r = torch.full(((near["cnt"] - k) * 8,), sizes[i] - 1, dtype=torch.int32,
                                   device=device)
                r = torch.cat([r, near["corners"][i].to(torch.int32).reshape(-1), pad_r])
            rows_l.append(r)
        return comm.all_gather(group, torch.stack(rows_l))

    def gathered_grads(grads, near):
        """The replicated island's gradients, as :func:`gathered_rows` (bf16
        when the kernel rounds them so; the near points' padded with zeros)."""
        g_l = []
        for i in range(L):
            g = grads[i].reshape(-1, D)
            if near is not None:
                k = near["corners"][i].shape[0]
                g = torch.cat([g, near["G"][i].grad.reshape(-1, D),
                               g.new_zeros(((near["cnt"] - k) * 8, D))])
            g_l.append(g)
        Gs = torch.stack(g_l)
        Gg = comm.all_gather(group, Gs.to(torch.bfloat16) if grads_bf16 else Gs)
        return [Gg[:, i].reshape(-1, D).float().contiguous() for i in range(L)]

    def _whole_reg(aux, reg):
        """The reg of replicated tables, which every rank holds whole (the
        touched rows summed across ranks): rank 0's counts in the chunk's
        sum across ranks."""
        share = reg if group.rank == 0 else torch.zeros_like(reg)
        aux["reg_loss"] = share
        aux["total_loss"] = aux["total_loss"] + s.lambda_forget * share

    def one_step(step, it):
        """One step (JAX's scan body): the batch, the loss and its
        gradients, the decoders' and the tables' update; returns the aux."""
        with span("step.forward"):
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
                    idx = (ray_idx[:, None] * S
                           + torch.arange(S, device=device)[None, :]).reshape(-1)
                else:
                    idx = torch.sort(draw).values if s.sort_batch else draw
            near = None
            if graphed:
                corners, G, total, aux = iid_forward(idx)
            else:
                counts = None
                idx_all = idx
                sl = None
                if dp:
                    # this rank's slice of the global batch; the loss's counts are
                    # the whole batch's
                    sl = group.batch_slice(idx.shape[0])
                    idx = idx[sl]
                    if ray_idx is not None:
                        ray_idx = ray_idx[group.batch_slice(s.bs)]
                    counts = {"n": int(idx_all.shape[0]), "n_rays": s.bs,
                              "n_sem": -(-int(idx_all.shape[0]) // s.sem_label_decimation),
                              "n_near": (int(near_indices.shape[1]) if near_indices is not None
                                         else min(s.consistency_count, int(idx_all.shape[0])))}
                    if s.ekional_loss_on or s.normal_loss_on:
                        counts["n_surf"] = (pool["weight"][idx_all] > 0).sum()
                batch = _gather_batch(pool, idx, s)
                if ray_idx is not None:
                    batch["ray_depth"] = pool["ray_depth"][ray_idx]
                corners = None
                if routed:
                    found = [pre_lookups[i][1][idx] for i in range(L)]
                elif pre_lookups is not None:
                    corners = [pre_lookups[i][0][idx] for i in range(L)]
                    found = [pre_lookups[i][1][idx] for i in range(L)]
                else:
                    corners, found = _lookups(tables, feats, batch["coord"], s.levels, sizes)
                if s.consistency_loss_on:
                    lo = sl.start if dp else 0
                    n_idx, n_coords = _near_points(s, batch["coord"], it, generator, near_indices,
                                                   near_shifts, int(idx_all.shape[0]), lo)
                    # live probes even with pool lookups: the near points are not pool samples
                    corners_n, found_n = _lookups(tables, feats, n_coords, s.levels, sizes)
                    near = {"idx": n_idx, "coords": n_coords, "corners": corners_n,
                            "found": found_n, "cnt": counts["n_near"] if dp else None}
                route = None
                if live:
                    route, G, G_near = live_rows(corners, found, near)
                    if near is not None:
                        near["G"] = G_near
                else:
                    if near is not None:
                        near["G"] = _gather_rows(feats, near["corners"], leaf=not autodiff)
                    G = routed_rows(wsel) if routed else _gather_rows(feats, corners,
                                                                      leaf=not autodiff)
                for p in dense.values():
                    p.grad = None
                if autodiff:
                    for f in feats:
                        f.grad = None

                total, aux = _compute_loss_sparse(params, G, batch, found, s, near, counts)
                if mode == "dense" and s.continual_reg_on and not dp:
                    reg = _dense_reg(s, shadow, feats, corners)
                    total = total + s.lambda_forget * reg
                    aux["reg_loss"] = reg
                    aux["total_loss"] = total
        with span("step.backward"):
            total.backward()

        with span("step.update"):
            lr = lr_at_step(s.lr, step, s.lr_decay_step, s.lr_iters_reduce_ratio)
            dense_grads = {k: p.grad for k, p in dense.items()}
            if dp:
                # the decoders' gradients summed across ranks (rank order)
                have = [k for k, g in dense_grads.items() if g is not None]
                dense_grads.update(zip(have, comm.sum_across(group,
                                                             [dense_grads[k] for k in have])))
                if autodiff:
                    summed = []
                    for i, f in enumerate(feats):
                        mine = corners[i].reshape(-1).long()
                        rows = torch.unique(torch.cat(
                            [mine] + ([near["corners"][i].reshape(-1).long()] if near is not None
                                      else [])))
                        vals = f.grad[rows]
                        if s.continual_reg_on:  # a last column marks the samples' rows (the reg's)
                            vals = torch.cat([vals, torch.isin(rows, mine).to(vals.dtype)[:, None]],
                                             dim=1)
                        summed.append(_sum_rows(group, rows, vals))
                    g_rows, reg = reg_rows([u for u, _ in summed], [t for _, t in summed])
                    for f, (u, _), g in zip(feats, summed, g_rows):
                        f.grad = torch.zeros_like(f.grad).index_put_((u,), g)
                    if reg is not None:
                        _whole_reg(aux, reg)
            if not s.opt_adam:
                # SGD runs the dense update only (JAX _resolve_mode)
                sgd_update(dense, dense_grads, opt_state, lr, lr_scale, wd)
                if live:
                    live_update(route, G, near["G"] if near else None, lr, None, None, aux)
                    return aux
                for i, f in enumerate(feats):
                    sgd_leaf(f, f.grad, m_feats[i], lr * lr_scale[FEATURES][i], 0.0)
                return aux
            adam_update(dense, dense_grads, opt_state, lr, lr_scale, wd, b1=0.9, b2=0.99,
                        eps=s.adam_eps)
            bc1, bc2 = bias_corrections(opt_state.step)
            if live:
                live_update(route, G, near["G"] if near else None, lr, bc1, bc2, aux)
                return aux
            if autodiff:
                for i, f in enumerate(feats):
                    adam_leaf(f, f.grad, m_feats[i], v_feats[i], lr * lr_scale[FEATURES][i], 0.0,
                              bc1, bc2, eps=s.adam_eps)
                return aux
            grads = [g_i.grad for g_i in G]
            if mode == "sparse":
                reg_total = None
                for i in range(L):
                    seg = sparse_adam.segment_by_row(corners[i], grads[i], feats[i].shape[0])
                    if dp:
                        seg = sparse_adam.SegmentedGrads(*_sum_rows(group, seg.rows, seg.grads))
                    kw = {}
                    if s.continual_reg_on:
                        kw = dict(reg_lambda=s.lambda_forget, importance=shadow["importance"][i],
                                  last_frame=shadow["last_frame"][i])
                    reg_i = sparse_adam.sparse_adam_level(
                        feats[i], m_feats[i], v_feats[i], seg, lr * lr_scale[FEATURES][i], bc1, bc2,
                        eps=s.adam_eps, **kw)
                    reg_total = reg_i if reg_total is None else reg_total + reg_i
                if s.continual_reg_on and dp:
                    _whole_reg(aux, reg_total)
                elif s.continual_reg_on:
                    aux["reg_loss"] = reg_total
                    aux["total_loss"] = aux["total_loss"] + s.lambda_forget * reg_total
                return aux
            if routed:
                routed_update(wsel, grads, lr, bc1, bc2, step)
                return aux
            if dp:
                R = gathered_rows(corners, near)  # (n, L, M_loc)
            if s.continual_reg_on:
                # replicated ranks fold the reg into their own entries before the
                # gather (bf16 entries rounded once), with their slice of the
                # whole batch's owner flags: the windows', or from every rank's
                # rows (a miss's row is the trashbin, which no found corner holds)
                if batch_windows is not None:
                    owner = [o[wsel] if sl is None else o[wsel][sl] for o in batch_windows.owner]
                elif dp:
                    b8 = corners[0].numel()
                    owner = [owner_flags(w, w[:, 0] != C - 1)[sl] for w, C in
                             zip((R[:, i, :b8].reshape(-1, 8) for i in range(L)), sizes)]
                else:
                    owner = [owner_flags(c, f) for c, f in zip(corners, found)]
                grads, reg = _reg_fold(s, shadow, corners, G, grads, owner)
                # over several ranks this rank's share: the chunk's sum adds them
                aux["reg_loss"] = reg
                aux["total_loss"] = aux["total_loss"] + s.lambda_forget * reg
            if dp:
                corners = [R[:, i].reshape(-1).contiguous() for i in range(L)]
                grads = gathered_grads(grads, near)
            elif near is not None:
                # the near points' rows ride the update as extra entries
                corners = [torch.cat([c.reshape(-1, 8), cn.reshape(-1, 8)])
                           for c, cn in zip(corners, near["corners"])]
                grads = [torch.cat([g, gn.grad]) for g, gn in zip(grads, near["G"])]
            kw = dict(eps=s.adam_eps, grads_bf16=grads_bf16)
            if dp:  # the replicas' deterministic sum
                kw["deterministic"] = True
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
            else:
                iid_update(corners, grads, lr, bc1, bc2, kw)
            return aux

    def iid_update(corners, grads, lr, bc1, bc2, kw):
        """The tables' update of an iid step: K2 over all levels under
        ``fuse_update_levels``, else K1 per level (on the card one prep and
        one launch for all levels)."""
        update = (adam_kernel.fused_adam_multi if s.fuse_update_levels
                  else adam_kernel.fused_adam_levels)
        dropped.add_(update(feats, m_feats, v_feats, corners, grads, lr, bc1, bc2,
                            lr_scale[FEATURES], n_used, **kw))

    def iid_forward(idx):
        """Steps 1-3 of an iid step on one card through the pool's lookups
        (the eager step and the recorded one): the batch at ``idx``, its
        corner rows and the loss.  Returns (corners, G, total, aux)."""
        batch = _gather_batch(pool, idx, s)
        corners = [pre_lookups[i][0][idx] for i in range(L)]
        found = [pre_lookups[i][1][idx] for i in range(L)]
        G = _gather_rows(feats, corners)
        for p in dense.values():
            p.grad = None
        total, aux = _compute_loss_sparse(params, G, batch, found, s)
        return corners, G, total, aux

    def graph_body(g: _StepGraph):
        """The recorded part of an iid step: from the drawn indices through
        the decoders' Adam, with the step's numbers read from
        ``g.scalars``."""
        with span("step.forward"):
            corners, G, total, aux = iid_forward(
                torch.sort(g.draw).values if s.sort_batch else g.draw)
        with span("step.backward"):
            total.backward()
        with span("step.update"):
            inv_bc1, inv_bc2 = g.scalars[len(dense)], g.scalars[len(dense) + 1]
            for j, (k, p) in enumerate(dense.items()):
                adam_leaf(p, p.grad, opt_state.m[k], opt_state.v[k],
                          None if k in zero_lr else g.scalars[j], wd[k], inv_bc1, inv_bc2,
                          eps=s.adam_eps)
        g.corners, g.grads = corners, [x.grad for x in G]
        g.aux_keys = tuple(aux)
        g.aux = torch.stack([a.detach() for a in aux.values()])

    def graph_step(it):
        """An iid step through the key's recorded graph, recorded at the
        key's second step; None at its first, which runs eagerly (warming
        cuBLAS and the allocator up).  The draw, the table update and the
        host's bookkeeping stay eager: the draw into the graph's index
        buffer from the same generator, and the step's Adam numbers,
        uploaded once a chunk, copied into its slot.  Returns the aux."""
        g = opt_state.graph
        if g is None:
            opt_state.graph = _StepGraph(key)
            return None
        if g.replay is None:
            for p in dense.values():
                p.grad = None
            g.draw = torch.empty((s.bs,), dtype=torch.int64, device=device)
            g.scalars = torch.empty((len(dense) + 2,), dtype=torch.float32, device=device)
            g.replay = _record_graph(lambda: graph_body(g))
            GRAPH_COUNTS["captured"] += 1
        with span("step.replay"):
            if not scalar_rows:  # every step advances Adam's count by one
                scalar_rows.append(torch.from_numpy(adam_scalars(
                    step_lrs, lr_scale, list(dense),
                    [opt_state.step + 1 + t - it for t in range(n_iters)])).to(device))
            lr = step_lrs[it]
            opt_state.step += 1
            bc1, bc2 = bias_corrections(opt_state.step)
            torch.randint(0, int(n_valid), (s.bs,), generator=generator, out=g.draw)
            g.scalars.copy_(scalar_rows[0][it])
            g.replay()
            iid_update(g.corners, g.grads, lr, bc1, bc2,
                       dict(eps=s.adam_eps, grads_bf16=grads_bf16))
            vals = g.aux.clone()
        GRAPH_COUNTS["replayed"] += 1
        return dict(zip(g.aux_keys, vals.unbind(0)))

    step_lrs = [lr_at_step(s.lr, start_iter + it, s.lr_decay_step, s.lr_iters_reduce_ratio)
                for it in range(n_iters)]
    # a step at lr 0 (a decay ratio of 0) leaves every leaf as it is: eager
    graphed = (step_graph_ok(s, device, group, pre_lookups, batch_windows, batch_indices)
               and all(step_lrs))
    # the leaves the update leaves as they are (frozen decoders), the chunk's
    # key, and its Adam numbers once the graph first replays
    zero_lr = frozenset(k for k in dense if lr_scale[k] == 0)
    key, scalar_rows = None, []
    if graphed:
        key = step_graph_key(params, opt_state, pool, pre_lookups, s, n_valid, zero_lr)
    if opt_state.graph is not None and opt_state.graph.key != key:
        opt_state.graph = None  # another key, or a path the graph does not take
    dropped = torch.zeros((), dtype=torch.int64, device=device)
    hist: List[Dict[str, torch.Tensor]] = []
    if autodiff:
        for f in feats:
            f.requires_grad_(True)
    with span("chunk"):
        try:
            for it in range(n_iters):
                step = start_iter + it
                with span("step"):
                    aux = graph_step(it) if graphed else None
                    if aux is None:
                        aux = one_step(step, it)
                        GRAPH_COUNTS["eager"] += 1
                hist.append({k: a.detach() for k, a in aux.items()})
                # no step's autograd graph outlives it: a recording's backward
                # would find the parameters' gradient accumulators of an eager
                # step's graph, bound to its stream, and fail
                del aux
        finally:
            if autodiff:
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
        if dp:
            # each rank's terms are its share of the whole batch's: sum them
            keys = sorted(stacked)
            stacked = dict(zip(keys, comm.sum_across(group, [stacked[k] for k in keys])))
        return params, opt_state, {
            "mean": {k: a.mean() for k, a in stacked.items()},
            "last": {k: a[-1] for k, a in stacked.items()},
        }
