"""Sparse (lazy) Adam on the feature tables' touched rows.

Port of ``shine_mapping_tpu/train/sparse_adam.py`` (the ``feature_update:
sparse`` mode): only the rows a batch touches are updated, so a step costs
what the batch touches, not the map's size.  The gradients are those of
dense Adam (gather and scatter are linear); untouched rows keep their
moments as they are instead of decaying them, the embedding-table
trade-off.

The JAX package sums a row's duplicate contributions by sort + cumsum
differences (an error of about eps * |prefix sum|) and packs ``[p|m|v]``
into one row, because XLA's scatter is entry-bound.  Here the duplicates
are summed directly (``torch.unique`` + ``index_add_``: in order on the CPU,
by atomics in no fixed order on the card) and p, m and v stay the separate
tables the checkpoint and ``interop.py`` hold.  The update is plain torch
on both devices: the JAX package has no TPU kernel for it to port.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class SegmentedGrads(NamedTuple):
    rows: torch.Tensor  # (S,) int64 ascending unique rows, the trashbin left out
    grads: torch.Tensor  # (S, D) float32 summed gradient per row


def segment_by_row(corners: torch.Tensor, contribs: torch.Tensor,
                   table_rows: int) -> SegmentedGrads:
    """Sum the contributions ``contribs`` (..., D) of the rows ``corners``
    (...) per unique row.  The trashbin row ``table_rows - 1`` is left out:
    it must stay zero (reference model/feature_octree.py:78-81)."""
    D = contribs.shape[-1]
    idx = corners.reshape(-1).long()
    rows, inv = torch.unique(idx, sorted=True, return_inverse=True)
    sums = torch.zeros((rows.shape[0], D), dtype=torch.float32, device=contribs.device)
    sums.index_add_(0, inv, contribs.reshape(-1, D).float())
    keep = rows != table_rows - 1
    return SegmentedGrads(rows=rows[keep], grads=sums[keep])


@torch.no_grad()
def sparse_adam_level(p: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
                      seg: SegmentedGrads, lr: float, bc1: float, bc2: float,
                      b1: float = 0.9, b2: float = 0.99, eps: float = 1e-15,
                      reg_lambda: float = 0.0, importance: Optional[torch.Tensor] = None,
                      last_frame: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Lazy Adam on one level's touched rows, in place (JAX
    ``sparse_adam_level``): ``bc1``, ``bc2`` are the global step's bias
    corrections and ``lr`` the level's (the per-level ratio applied).  With
    ``reg_lambda`` > 0 the continual-learning penalty
    ``sum importance * (p - last)^2`` over the touched rows (reference
    ``cal_regularization``, model/feature_octree.py:246-255) adds its
    gradient to the rows' and its value is returned (0 otherwise).  As in
    the JAX package each table is written as ``x + delta``."""
    rows = seg.rows
    g = seg.grads
    p_rows, m_rows, v_rows = p[rows], m[rows], v[rows]
    reg = torch.zeros((), dtype=torch.float32, device=p.device)
    if reg_lambda > 0.0 and importance is not None and last_frame is not None:
        imp = importance[rows]
        diff = p_rows - last_frame[rows]
        reg = torch.sum(imp * diff * diff)
        g = g + (reg_lambda * 2.0) * imp * diff
    m_new = b1 * m_rows + (1.0 - b1) * g
    v_new = b2 * v_rows + (1.0 - b2) * g * g
    update = lr * (m_new / bc1) / (torch.sqrt(v_new / bc2) + eps)
    p[rows] = p_rows + (-update)
    m[rows] = m_rows + (m_new - m_rows)
    v[rows] = v_rows + (v_new - v_rows)
    return reg
