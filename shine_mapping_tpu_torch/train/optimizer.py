"""Adam (and SGD with momentum) with parameter groups and step LR decay.

Port of ``shine_mapping_tpu/train/optimizer.py`` (reference
``setup_optimizer``, utils/tools.py:57-83, and ``step_lr_decay``,
utils/tools.py:135-155): betas (0.9, 0.99), eps 1e-15, weight decay on the
MLP decoders only, featured level ``i`` (finest = 0) at
``lr * lr_level_reduce_ratio**i``.

The JAX package threads pytrees through pure functions; here the optimizer
state is a mutable :class:`OptState` whose moments are updated in place.
Dense parameters (decoders, sigma) are addressed by flat names
(``geo.layers.0.weight``, ``sigma``); the feature tables are a list under
``"features"`` and are stepped by ``ops/adam_kernel.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence

import torch

FEATURES = "features"


@dataclasses.dataclass
class OptState:
    m: Dict[str, Any]  # flat dense names -> tensor, plus "features": [tensor]
    v: Dict[str, Any]
    step: int = 0


def dense_params(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The canonical parameter dict's dense leaves by flat name.

    ``params`` holds ``geo`` / ``sem`` (:class:`~..models.decoder.Decoder`),
    ``features`` (per-level tables) and ``sigma`` (0-dim tensor)."""
    out: Dict[str, torch.Tensor] = {}
    for k, v in params.items():
        if k == FEATURES:
            continue
        if isinstance(v, torch.nn.Module):
            for name, p in v.named_parameters():
                out[f"{k}.{name}"] = p
        else:
            out[k] = v
    return out


def init_opt_state(params: Dict[str, Any], moments_bf16: bool = False) -> OptState:
    """Zero Adam state.  The feature tables' moments are float32, or bfloat16
    with ``moments_bf16`` (``tpu.moments_bf16``: the update computes in f32
    and stores them rounded to nearest even); the decoders' and sigma's
    moments stay float32, as in the JAX package."""
    m = {k: torch.zeros_like(p) for k, p in dense_params(params).items()}
    v = {k: torch.zeros_like(p) for k, p in dense_params(params).items()}
    dtype = torch.bfloat16 if moments_bf16 else torch.float32
    m[FEATURES] = [torch.zeros(f.shape, dtype=dtype, device=f.device) for f in params[FEATURES]]
    v[FEATURES] = [torch.zeros(f.shape, dtype=dtype, device=f.device) for f in params[FEATURES]]
    return OptState(m=m, v=v, step=0)


def lr_at_step(
    base_lr: float, iteration: int, decay_steps: Sequence[int], reduce: float
) -> float:
    """LR after step decay: base * reduce^(#decay steps passed).

    Matches reference ``step_lr_decay`` (utils/tools.py:135-155)."""
    passed = sum(int(iteration >= s) for s in decay_steps)
    return base_lr * (reduce ** passed)


def bias_corrections(step: int, b1: float = 0.9, b2: float = 0.99):
    """Adam's (1 - b1^t, 1 - b2^t) for the step just taken."""
    return 1.0 - b1 ** step, 1.0 - b2 ** step


@torch.no_grad()
def adam_update(
    params: Dict[str, torch.Tensor],
    grads: Dict[str, Optional[torch.Tensor]],
    state: OptState,
    lr: float,
    lr_scale: Dict[str, float],
    wd: Dict[str, float],
    b1: float = 0.9,
    b2: float = 0.99,
    eps: float = 1e-15,
) -> None:
    """One Adam step on the flat-named dense ``params``, in place.

    Increments ``state.step``.  A missing gradient is a zero gradient, as in
    JAX where an unused leaf's gradient is zeros.  Weight decay is added to
    the gradient torch-style (grad += wd * param).  A parameter whose
    ``lr * lr_scale`` is 0 (a frozen decoder) keeps its value bit for bit
    while its moments advance."""
    state.step += 1
    bc1, bc2 = bias_corrections(state.step, b1, b2)
    for k, p in params.items():
        adam_leaf(p, grads.get(k), state.m[k], state.v[k], lr * lr_scale[k], wd[k],
                  bc1, bc2, b1, b2, eps)


@torch.no_grad()
def adam_leaf(p: torch.Tensor, g: Optional[torch.Tensor], m: torch.Tensor,
              v: torch.Tensor, lr: float, wd: float, bc1: float, bc2: float,
              b1: float = 0.9, b2: float = 0.99, eps: float = 1e-15) -> None:
    """One tensor's Adam step in place, at learning rate ``lr`` (the group's
    scale applied), with the step's bias corrections ``bc1``, ``bc2``."""
    g = torch.zeros_like(p) if g is None else g
    if wd:
        g = g + wd * p
    m.mul_(b1).add_((1.0 - b1) * g)
    v.mul_(b2).add_((1.0 - b2) * (g * g))
    if lr:
        p.sub_(lr * (m / bc1) / (torch.sqrt(v / bc2) + eps))


@torch.no_grad()
def sgd_update(
    params: Dict[str, torch.Tensor],
    grads: Dict[str, Optional[torch.Tensor]],
    state: OptState,
    lr: float,
    lr_scale: Dict[str, float],
    wd: Dict[str, float],
    momentum: float = 0.9,
) -> None:
    """SGD with momentum on the flat-named ``params``, in place (reference
    utils/tools.py:81, ``optim.SGD(momentum=0.9)``; JAX ``sgd_update``):
    ``m = momentum * m + g``, ``p -= lr * scale * m``, weight decay added to
    the gradient.  The moments live in ``state.m``; ``state.v`` is unused.
    Increments ``state.step``."""
    state.step += 1
    for k, p in params.items():
        sgd_leaf(p, grads.get(k), state.m[k], lr * lr_scale[k], wd[k], momentum)


@torch.no_grad()
def sgd_leaf(p: torch.Tensor, g: Optional[torch.Tensor], m: torch.Tensor, lr: float,
             wd: float, momentum: float = 0.9) -> None:
    """One tensor's SGD-with-momentum step in place, at learning rate ``lr``
    (the group's scale applied)."""
    g = torch.zeros_like(p) if g is None else g
    if wd:
        g = g + wd * p
    m.mul_(momentum).add_(g)
    p.sub_(lr * m)


def make_group_trees(params: Dict[str, Any], level_lr_ratio: float,
                     weight_decay: float):
    """(lr_scale, wd) per parameter group (reference utils/tools.py:57-83).

    Decoders (``geo.*``, ``sem.*``) get weight decay; the feature tables get
    ``level_lr_ratio**i`` and no decay (``lr_scale["features"]`` is a list);
    sigma gets the base lr and no decay."""
    lr_scale: Dict[str, Any] = {}
    wd: Dict[str, Any] = {}
    for k in dense_params(params):
        group = k.split(".", 1)[0]
        lr_scale[k] = 1.0
        wd[k] = weight_decay if group in ("geo", "sem") else 0.0
    n = len(params[FEATURES])
    lr_scale[FEATURES] = [float(level_lr_ratio ** i) for i in range(n)]
    wd[FEATURES] = [0.0] * n
    return lr_scale, wd
