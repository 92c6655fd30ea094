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

import numpy as np
import torch

FEATURES = "features"


@dataclasses.dataclass
class OptState:
    m: Dict[str, Any]  # flat dense names -> tensor, plus "features": [tensor]
    v: Dict[str, Any]
    step: int = 0
    # the trainer's recorded iid step (train.trainer), kept with the state it
    # updates; never saved
    graph: Any = None


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
              v: torch.Tensor, lr, wd: float, bc1, bc2,
              b1: float = 0.9, b2: float = 0.99, eps: float = 1e-15) -> None:
    """One tensor's Adam step in place, at learning rate ``lr`` (the group's
    scale applied; 0 or None keeps ``p`` as it is), with the step's bias
    corrections ``bc1``, ``bc2``.  The three are Python numbers, or 0-dim
    float32 device tensors (:func:`adam_scalars`) where a recorded CUDA
    graph reads them anew at each replay, the corrections then as their
    reciprocals: torch multiplies a CUDA tensor by a Python scalar rounded
    to float32 and divides it by one as a multiply by the reciprocal rounded
    to float32, so on CUDA tensors both forms compute the same bits."""
    g = torch.zeros_like(p) if g is None else g
    if wd:
        g = g + wd * p
    m.mul_(b1).add_((1.0 - b1) * g)
    v.mul_(b2).add_((1.0 - b2) * (g * g))
    if lr is None or not (torch.is_tensor(lr) or lr):
        return
    if torch.is_tensor(bc1):
        p.sub_(lr * (m * bc1) / (torch.sqrt(v * bc2) + eps))
    else:
        p.sub_(lr * (m / bc1) / (torch.sqrt(v / bc2) + eps))


def adam_scalars(lrs: Sequence[float], lr_scale: Dict[str, float], names: Sequence[str],
                 steps: Sequence[int], b1: float = 0.9, b2: float = 0.99) -> np.ndarray:
    """The numbers :func:`adam_leaf` reads from the device, one row for each
    Adam step ``steps[t]`` at learning rate ``lrs[t]``: float32 ``lr *
    lr_scale[k]`` for each of ``names``, then the bias corrections' reciprocals, taken in
    float64 and rounded to float32, as torch computes them on the host where
    :func:`adam_leaf` multiplies or divides a CUDA tensor by a Python scalar
    (the reciprocal of the float32 correction differs from it in the last
    bit at some steps: 2 for b2 0.99, 5 and 7 for b1 0.9).  (T, len(names)
    + 2) float32."""
    scale = np.array([lr_scale[k] for k in names], dtype=np.float64)
    lr32 = (np.asarray(lrs, dtype=np.float64)[:, None] * scale[None, :]).astype(np.float32)
    bc = np.array([bias_corrections(t, b1, b2) for t in steps], dtype=np.float64)
    return np.concatenate([lr32, (1.0 / bc.reshape(-1, 2)).astype(np.float32)], axis=1)


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
