"""Continual-learning feature-importance accumulation.

Port of ``shine_mapping_tpu/train/importance.py`` (reference
``cal_feature_importance``, utils/incre_learning.py:8-40): after each
incremental frame, run the forward + backward over the whole pool in
strided batches and accumulate the absolute feature-table gradient into the
importance weights (trashbin row kept at zero).  No TPU kernel is on this
path (JAX compiles it as one XLA scan); here it is plain torch on the
tables' device, one batch after another.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..models.decoder import Decoder
from . import losses
from .trainer import feat_from_rows, lookup_rows


def _pool_tensor(a, device) -> torch.Tensor:
    """A host array or a tensor of the pool, as float32 on ``device``."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=torch.float32)
    return torch.from_numpy(np.asarray(a, dtype=np.float32)).to(device)


def cal_feature_importance(
    grid,
    geo: Decoder,
    pool_coord,
    pool_sdf_label,
    sigma: float,
    bs: int,
    down_rate: int = 1,
    loss_reduction: str = "mean",
    group=None,
) -> None:
    """Accumulate |d loss / d features| over the pool into
    ``grid.importance_weight`` (replaced by new tensors on the grid).

    The batches are JAX's (utils/incre_learning.py:15-27): batch ``k``
    takes pool samples ``k * bs * down_rate + arange(bs) * down_rate``, and
    a sample past the pool's ``n`` weighs 0 in the sdf_bce loss, so the
    ``"mean"`` reduction of the last partial batch still divides by ``bs``.
    JAX runs its batches over the pool padded to ``max(pow2(n), 1024)``;
    the batches past ``n`` hold no sample and add exactly zero, so they are
    not run.  Each batch's gradient is summed per table row before its
    absolute value is taken and added (a row touched twice in a batch adds
    ``|g1 + g2|``, as JAX's gradient w.r.t. the whole table does).

    ``pool_coord`` (n, 3) and ``pool_sdf_label`` (n,): numpy arrays or
    tensors (the driver passes the head of its device pool, so nothing is
    uploaded again).  ``geo`` takes no gradient.

    ``group`` (a ``parallel.mesh.DataGroup`` of several ranks, each holding
    the whole tables and pool): rank k sweeps batches k, k + n, ..., and the
    ranks' accumulated tables are added in rank order (``comm.sum_across``),
    so every rank holds the same bits (a row's per-batch sum, by atomics on
    the card, is taken on one rank only)."""
    device = grid.features[0].device
    coord = _pool_tensor(pool_coord, device)
    label = _pool_tensor(pool_sdf_label, device)
    n = int(coord.shape[0])
    interval = bs * down_rate
    levels = tuple(grid.levels)
    poly = grid.polynomial_interpolation
    feats = list(grid.features)
    acc = [torch.zeros(f.shape, dtype=torch.float32, device=device) for f in feats]
    step = torch.arange(bs, device=device) * down_rate
    dp = group is not None and group.world > 1
    mine = range(group.rank if dp else 0, math.ceil(n / interval), group.world if dp else 1)
    for k in mine:
        idx = k * interval + step
        valid = (idx < n).to(torch.float32)
        idx = idx.clamp(max=n - 1)  # past the pool: weight 0, an exact zero gradient
        c = coord[idx]
        corners, found, G = lookup_rows(grid.tables, feats, c, levels)
        pred = geo.sdf(feat_from_rows(c, G, found, levels, poly))
        loss = losses.sdf_bce_loss(pred, label[idx], sigma, valid, True, loss_reduction)
        g_rows = torch.autograd.grad(loss, G)
        for i, (g, rows) in enumerate(zip(g_rows, corners)):
            D = g.shape[-1]
            g_tab = torch.zeros_like(acc[i]).index_add_(0, rows.reshape(-1).long(),
                                                         g.reshape(-1, D))
            acc[i] += g_tab.abs()
    if dp:
        from ..parallel import comm

        acc = comm.sum_across(group, acc)
    for i in range(len(acc)):
        upd = grid.importance_weight[i] + acc[i]
        upd[-1] = 0.0  # trashbin row (utils/incre_learning.py:40)
        grid.importance_weight[i] = upd
