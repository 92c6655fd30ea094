"""Training losses of the main path.

Port of ``shine_mapping_tpu/train/losses.py`` (reference utils/loss.py and
shine_batch.py:160-204): ``sdf_bce_loss``, ``sdf_diff_loss``,
``batch_ray_rendering_loss`` (with the NeuS alpha), ``safe_norm``,
``eikonal_loss``, ``normal_loss``, ``consistency_loss`` and
``sem_nll_loss``.
"""

from __future__ import annotations

from typing import Optional

import torch


def _reduce(x: torch.Tensor, reduction: str) -> torch.Tensor:
    if reduction == "mean":
        return torch.mean(x)
    if reduction == "sum":
        return torch.sum(x)
    raise ValueError(f"unknown reduction {reduction}")


def sdf_bce_loss(
    pred: torch.Tensor,
    label: torch.Tensor,
    sigma: float,
    weight: Optional[torch.Tensor] = None,
    weighted: bool = False,
    bce_reduction: str = "mean",
) -> torch.Tensor:
    """BCEWithLogits(pred, sigmoid(label / sigma)) — utils/loss.py:17-24.

    The same stable form as the JAX package, max(x,0) - x*t + log1p(exp(-|x|)),
    so the two agree to float32 rounding."""
    target = torch.sigmoid(label / sigma)
    x = pred
    per = torch.clamp(x, min=0.0) - x * target + torch.log1p(torch.exp(-torch.abs(x)))
    if weighted and weight is not None:
        per = per * weight
    return _reduce(per, bce_reduction)


def sdf_diff_loss(
    pred: torch.Tensor,
    label: torch.Tensor,
    weight: torch.Tensor,
    scale: float,
    l2_loss: bool = True,
    count=None,
) -> torch.Tensor:
    """Weighted L1/L2 sdf regression in metres — utils/loss.py:6-14.
    ``count``: the batch's size when this is a rank's share of it."""
    count = pred.shape[0] if count is None else count
    diff_m = (pred - label) / scale
    if l2_loss:
        return torch.sum(weight * diff_m ** 2) / count
    return torch.sum(weight * torch.abs(diff_m)) / count


def batch_ray_rendering_loss(
    x: torch.Tensor, y: torch.Tensor, d_meas: torch.Tensor, neus_on: bool = True,
    count=None,
) -> torch.Tensor:
    """Volume-rendered depth vs measured depth — utils/loss.py:82-118.

    ``x`` (R, S) sample depths per ray, ``y`` (R, S) predicted occupancy
    probabilities, ``d_meas`` (R,) measured depths; ``neus_on``: NeuS's
    unbiased occlusion-aware alpha.  The samples are sorted by depth with a
    gather, so the gradient reaches ``y`` through the permutation.  As in
    the JAX package the transmittance is the exclusive cumprod of
    1 - alpha, which has no divide by 1 - alpha and no NaN gradient when
    alpha saturates at 1 (the reference's cumprod(1-a)/(1-a) has both).
    ``count``: the batch's rays when these are a rank's share of them."""
    order = torch.argsort(x, dim=1, stable=True)
    sort_x = torch.gather(x, 1, order)
    sort_y = torch.gather(y, 1, order)
    if neus_on:
        neus_alpha = (sort_y[:, 1:] - sort_y[:, :-1]) / (1.0 - sort_y[:, :-1] + 1e-10)
        # jnp.clip is minimum(maximum(x, 0), 1), whose gradient at a tie
        # (alpha exactly 1 where the occupancy saturates) is split in half;
        # torch.minimum / maximum split ties alike, torch.clamp does not
        alpha = torch.minimum(torch.maximum(neus_alpha, torch.zeros_like(neus_alpha)),
                              torch.ones_like(neus_alpha))
    else:
        alpha = sort_y
    one_minus_alpha = 1.0 - alpha + 1e-10
    cum = torch.cumprod(one_minus_alpha, dim=1)
    exclusive = torch.cat([torch.ones_like(cum[:, :1]), cum[:, :-1]], dim=1)
    weights = exclusive * alpha
    d_render = torch.sum(weights * sort_x[:, : alpha.shape[1]], dim=1)
    if count is not None:
        return torch.sum(torch.abs(d_render - d_meas)) / count
    return torch.mean(torch.abs(d_render - d_meas))


def safe_norm(x: torch.Tensor, dim: int = -1, keepdim: bool = False) -> torch.Tensor:
    """|x| with a ZERO subgradient at x == 0.

    An all-levels-missed sample has an exactly-zero point gradient.  A norm
    written as sqrt(sum x^2) has an infinite derivative there, and in the
    eikonal term's second-order backward 0 * inf NaNs every parameter even
    where a mask zeroes the sample's loss (CLAUDE.md, "Numerical gotchas").
    Double-where, as in the JAX package: the sqrt never sees 0 on the branch
    that is taken, so the subgradient at 0 is 0 (torch's norm convention)."""
    sq = torch.sum(x * x, dim=dim, keepdim=keepdim)
    pos = sq > 0
    safe = torch.sqrt(torch.where(pos, sq, torch.ones_like(sq)))
    return torch.where(pos, safe, torch.zeros_like(sq))


def eikonal_loss(grads: torch.Tensor, surface_mask: torch.Tensor, count=None) -> torch.Tensor:
    """Mean (1 - |grad|)^2 over surface samples — shine_batch.py:183-185.

    The mask weights the mean (static shapes, as in the JAX package).
    ``count``: the batch's surface samples when these are a rank's share."""
    norms = safe_norm(grads, dim=-1)
    per = (1.0 - norms) ** 2
    m = surface_mask.to(per.dtype)
    return torch.sum(per * m) / _masked_count(m, count)


def _masked_count(m: torch.Tensor, count) -> torch.Tensor:
    n = torch.sum(m) if count is None else torch.as_tensor(count, dtype=m.dtype,
                                                           device=m.device)
    return torch.clamp(n, min=1.0)


def normal_loss(grads: torch.Tensor, normal_label: torch.Tensor,
                surface_mask: torch.Tensor, count=None) -> torch.Tensor:
    """Gradient direction vs measured normal, L2 — shine_batch.py:192-197.
    ``count``: as :func:`eikonal_loss`'s."""
    g_dir = grads / (safe_norm(grads, dim=-1, keepdim=True) + 1e-12)
    per = safe_norm(torch.abs(g_dir - normal_label), dim=1)
    m = surface_mask.to(per.dtype)
    return torch.sum(per * m) / _masked_count(m, count)


def consistency_loss(g_a: torch.Tensor, g_b: torch.Tensor, count=None) -> torch.Tensor:
    """1 - cosine similarity between the gradients of nearby points
    (shine_batch.py:187-190).  ``count``: the batch's near points when
    these are a rank's share."""
    na = safe_norm(g_a, dim=-1) + 1e-12
    nb = safe_norm(g_b, dim=-1) + 1e-12
    cos = torch.sum(g_a * g_b, dim=-1) / (na * nb)
    if count is not None:
        return torch.sum(1.0 - cos) / count
    return torch.mean(1.0 - cos)


def sem_nll_loss(log_prob: torch.Tensor, label: torch.Tensor, count=None) -> torch.Tensor:
    """NLL of log-softmax semantic predictions — shine_batch.py:200-204.
    ``count``: the batch's labels when these are a rank's share."""
    picked = torch.gather(log_prob, 1, label[:, None].long())
    if count is not None:
        return -torch.sum(picked) / count
    return -torch.mean(picked)
