"""Carry weights between the JAX package and the port.

The JAX package keeps its parameters as a pytree
``{"geo": {w0, b0, ..., w_out, b_out, w_sem, b_sem}, "sem": {...},
"features": (tables...), "sigma": scalar}`` and its Adam state as
``OptState(m, v, step)`` with ``m``/``v`` of the same structure.  These
functions take that structure as numpy arrays (``jax.device_get`` of it)
and build the port's (``train.trainer.init_params`` layout and
``train.optimizer.OptState``), or the inverse.  JAX's ``w{i}`` is
``(in, out)``; ``nn.Linear.weight`` is ``(out, in)``: weights are transposed.

The continual-learning shadow, ``{"importance": (tables...),
"last_frame": (tables...)}`` (JAX ``train_chunk``'s ``shadow`` argument,
the port's ``train_chunk(shadow=...)``), crosses the same way.

Feature tables and their moments keep their dtype: float32, or bfloat16 (the
bf16 map mode), which numpy holds as ``ml_dtypes.bfloat16`` on the JAX side.
Those cross through a 16-bit integer view, so no value is rounded either way.
Imports numpy and torch only (``ml_dtypes`` where a bf16 table goes to JAX).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .models.decoder import Decoder, decoder_from_state_dict
from .train.optimizer import FEATURES, OptState, dense_params

# JAX decoder leaf -> (torch parameter name, transpose?)
_LEAVES = {"w_out": ("lout.weight", True), "b_out": ("lout.bias", False),
           "w_sem": ("nclass_out.weight", True), "b_sem": ("nclass_out.bias", False)}


def _torch_name(jax_leaf: str):
    if jax_leaf in _LEAVES:
        return _LEAVES[jax_leaf]
    kind, i = jax_leaf[0], int(jax_leaf[1:])
    return (f"layers.{i}.weight", True) if kind == "w" else (f"layers.{i}.bias", False)


def _table_from_numpy(a, device) -> torch.Tensor:
    """A float32 or ``ml_dtypes.bfloat16`` table -> a torch tensor of the same
    dtype and bits (a copy)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16).to(device)
    return torch.tensor(a.astype(np.float32), device=device)


def _table_to_numpy(t: torch.Tensor) -> np.ndarray:
    """The inverse of :func:`_table_from_numpy`."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16).copy()
    return t.numpy()


def _decoder_state(jax_dec: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A JAX decoder dict -> a ``Decoder.state_dict()``-shaped dict."""
    out = {}
    for leaf, arr in jax_dec.items():
        name, tr = _torch_name(leaf)
        a = np.asarray(arr, dtype=np.float32)
        out[name] = torch.tensor(a.T if tr else a)  # a copy
    return out


def _jax_decoder(state: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    out = {}
    for name, t in state.items():
        a = t.detach().cpu().numpy()
        if name.startswith("layers."):
            _, i, kind = name.split(".")
            leaf = ("w" if kind == "weight" else "b") + i
        else:
            leaf = next(k for k, (n, _) in _LEAVES.items() if n == name)
        out[leaf] = a.T.copy() if a.ndim == 2 else a.copy()
    return out


def decoder_from_jax(jax_dec: Dict[str, Any], device="cuda") -> Decoder:
    """A JAX decoder dict -> a port :class:`Decoder` with the same weights
    (a time-conditioned one's first layer takes D + 1 inputs)."""
    return decoder_from_state_dict(_decoder_state(jax_dec), device)


def params_from_jax(jax_params: Dict[str, Any], device="cuda") -> Dict[str, Any]:
    """The JAX package's parameter pytree (numpy) -> the port's parameters."""
    return {
        "geo": decoder_from_jax(jax_params["geo"], device),
        "sem": decoder_from_jax(jax_params["sem"], device),
        FEATURES: [_table_from_numpy(f, device) for f in jax_params[FEATURES]],
        "sigma": torch.tensor(np.asarray(jax_params["sigma"], np.float32),
                              device=device),
    }


def opt_state_from_jax(jax_opt, params: Dict[str, Any]) -> OptState:
    """The JAX ``OptState`` (numpy leaves) -> the port's, keyed like
    ``params``'s dense leaves (``optimizer.dense_params``)."""
    device = params[FEATURES][0].device

    def moments(tree):
        flat: Dict[str, Any] = {}
        for grp in ("geo", "sem"):
            for name, t in _decoder_state(tree[grp]).items():
                flat[f"{grp}.{name}"] = t.to(device)
        flat["sigma"] = torch.tensor(np.asarray(tree["sigma"], np.float32), device=device)
        flat[FEATURES] = [_table_from_numpy(f, device) for f in tree[FEATURES]]
        missing = set(dense_params(params)) - set(flat)
        if missing:
            raise KeyError(f"moments missing for {sorted(missing)}")
        return flat

    return OptState(m=moments(jax_opt.m), v=moments(jax_opt.v),
                    step=int(np.asarray(jax_opt.step)))


def params_to_jax(params: Dict[str, Any]) -> Dict[str, Any]:
    """The port's parameters -> the JAX package's pytree layout (numpy)."""
    return {
        "geo": _jax_decoder(params["geo"].state_dict()),
        "sem": _jax_decoder(params["sem"].state_dict()),
        FEATURES: tuple(_table_to_numpy(f) for f in params[FEATURES]),
        "sigma": params["sigma"].detach().cpu().numpy(),
    }


def opt_state_to_jax(opt: OptState) -> Dict[str, Any]:
    """The port's OptState -> ``{"m": tree, "v": tree, "step": int}`` in the
    JAX package's layout (numpy)."""

    def tree(flat):
        out: Dict[str, Any] = {}
        for grp in ("geo", "sem"):
            out[grp] = _jax_decoder({k.split(".", 1)[1]: t for k, t in flat.items()
                                     if k.startswith(grp + ".")})
        out["sigma"] = flat["sigma"].detach().cpu().numpy()
        out[FEATURES] = tuple(_table_to_numpy(f) for f in flat[FEATURES])
        return out

    return {"m": tree(opt.m), "v": tree(opt.v), "step": int(opt.step)}


SHADOW = ("importance", "last_frame")


def shadow_from_jax(jax_shadow: Dict[str, Any], device="cuda") -> Dict[str, Any]:
    """The JAX shadow (numpy tables) -> the port's, each table a copy."""
    return {k: [_table_from_numpy(t, device) for t in jax_shadow[k]] for k in SHADOW}


def shadow_to_jax(shadow: Dict[str, Any]) -> Dict[str, Any]:
    """The port's shadow -> the JAX package's layout (numpy tuples)."""
    return {k: tuple(_table_to_numpy(t) for t in shadow[k]) for k in SHADOW}
