"""Multi-level feature query: hash lookup + gather + interpolate + sum.

Port of ``shine_mapping_tpu/ops/query.py`` (reference
``FeatureOctree.query_feature``, model/feature_octree.py:222-244).  Per
featured level, locate the containing node, gather its 8 corner rows, weight
them by the trilinear / smoothstep coefficients and sum across levels.
Misses contribute zero for that level (the trashbin convention).

Autograd reaches the feature tables through the gather (its backward is a
scatter-add) and the query coordinates through the interpolation weights,
so the eikonal loss can differentiate the field w.r.t. the points.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from .hashgrid import LevelTable, lookup_level
from .interp import corner_weights


def query_feature(
    coords: torch.Tensor,
    tables: Sequence[LevelTable],
    features: Sequence[torch.Tensor],
    levels: Tuple[int, ...],
    poly_on: bool = True,
) -> torch.Tensor:
    """(N,3) coords -> (N,D) hierarchically-summed interpolated features."""
    feat, _, _ = query_feature_with_aux(coords, tables, features, levels, poly_on)
    return feat


def query_feature_with_aux(
    coords: torch.Tensor,
    tables: Sequence[LevelTable],
    features: Sequence[torch.Tensor],
    levels: Tuple[int, ...],
    poly_on: bool = True,
) -> Tuple[torch.Tensor, List[torch.Tensor], List[torch.Tensor]]:
    """Full query also returning per-level corner rows and found masks.

    Returns:
        feat: (N, D) summed feature.
        corners_per_level: list of (N, 8) int32 rows (bottom-up order).
        found_per_level: list of (N,) bool.
    """
    feat = None
    corners_per_level: List[torch.Tensor] = []
    found_per_level: List[torch.Tensor] = []
    for i, level in enumerate(levels):
        corners, found = lookup_level(tables[i], coords, level)
        w = corner_weights(coords, level, poly_on)  # (N, 8)
        w = torch.where(found[:, None], w, torch.zeros_like(w))
        # bf16 tables: the rows widen (exactly) to f32 before interpolation
        gathered = features[i][corners.long()].float()  # (N, 8, D)
        contrib = torch.einsum("nc,ncd->nd", w.to(gathered.dtype), gathered)
        feat = contrib if feat is None else feat + contrib
        corners_per_level.append(corners)
        found_per_level.append(found)
    return feat, corners_per_level, found_per_level
