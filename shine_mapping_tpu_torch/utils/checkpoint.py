"""Checkpoint save / load in the JAX package's ``.npz`` format, both ways.

Port of ``shine_mapping_tpu/utils/checkpoint.py`` (reference
``save_checkpoint`` / ``save_decoder``, utils/tools.py:200-230): the map
structure (``grid_*``, from ``HashGridHost.state_dict``), the parameters,
the Adam moments and the iteration counter in one uncompressed ``.npz``;
plus the decoders-only export.

The JAX package names the leaves of each pytree by their index in
``jax.tree_util`` flatten order (``params__{i}``, ``optm__{i}``,
``optv__{i}``; bf16 leaves as ``params__{i}__bf16`` uint16 bit patterns).
That order is dict keys sorted, tuples in order: ``features`` (one leaf per
level), then ``geo``'s and ``sem``'s sorted keys (``b0, b1, b_out, b_sem, w0,
w1, w_out, w_sem``), then ``sigma``.  This module lays the port's
parameters out in that tree without jax (decoder weights transposed:
``nn.Linear`` keeps (out, in)), writes the same keys and the same
``__treedef`` string, and reads either package's files.  A
time-conditioned geometry decoder (first layer D + 1 inputs) crosses the
same way.  :func:`load_decoders` also reads the reference's ``.pth``
decoders (``models.decoder.load_torch_decoder``).
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..interop import _LEAVES, _torch_name, decoder_from_jax
from ..train.optimizer import FEATURES, OptState


class _Leaf(NamedTuple):
    tensor: torch.Tensor
    transpose: bool  # nn.Linear's (out, in) weight against JAX's (in, out)


def _decoder_leaves(named) -> Dict[str, Tuple[str, bool]]:
    """JAX leaf name -> (torch name, transpose) for a decoder whose tensors
    ``named`` holds under their ``Decoder.state_dict`` names."""
    n = sum(1 for k in named if k.startswith("layers.") and k.endswith(".weight"))
    cands = [f"{kind}{i}" for i in range(n) for kind in "wb"] + list(_LEAVES)
    return {leaf: _torch_name(leaf) for leaf in cands if _torch_name(leaf)[0] in named}


def _jax_tree(geo: Dict[str, torch.Tensor], sem: Dict[str, torch.Tensor],
              features, sigma) -> Dict[str, Any]:
    """The JAX package's pytree layout with :class:`_Leaf` leaves."""

    def dec(named):
        return {leaf: _Leaf(named[name], tr) for leaf, (name, tr) in _decoder_leaves(named).items()}

    return {FEATURES: tuple(_Leaf(f, False) for f in features), "geo": dec(geo),
            "sem": dec(sem), "sigma": _Leaf(sigma, False)}


def _params_tree(params) -> Dict[str, Any]:
    return _jax_tree(params["geo"].state_dict(), params["sem"].state_dict(),
                     params[FEATURES], params["sigma"])


def _moments_tree(flat) -> Dict[str, Any]:
    def group(g):
        return {k.split(".", 1)[1]: t for k, t in flat.items() if k.startswith(g + ".")}

    return _jax_tree(group("geo"), group("sem"), flat[FEATURES], flat["sigma"])


def _flatten_tree(tree) -> List[_Leaf]:
    """Leaves in ``jax.tree_util.tree_flatten`` order (``features`` first)."""
    if isinstance(tree, _Leaf):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flatten_tree(tree[k])]
    return [x for v in tree for x in _flatten_tree(v)]


def _treedef(tree) -> str:
    """``str(treedef)`` as jax prints it for this structure."""

    def f(x):
        if isinstance(x, _Leaf):
            return "*"
        if isinstance(x, dict):
            return "{" + ", ".join(f"'{k}': {f(x[k])}" for k in sorted(x)) + "}"
        return "(" + ", ".join(f(v) for v in x) + ("," if len(x) == 1 else "") + ")"

    return f"PyTreeDef({f(tree)})"


def _to_numpy(t: torch.Tensor, transpose: bool) -> np.ndarray:
    t = t.detach()
    if transpose:
        t = t.t()
    t = t.contiguous().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _flatten(prefix: str, tree, out: Dict[str, np.ndarray]) -> None:
    out[prefix + "__treedef"] = np.frombuffer(_treedef(tree).encode(), dtype=np.uint8)
    for i, (t, tr) in enumerate(_flatten_tree(tree)):
        suffix = "__bf16" if t.dtype == torch.bfloat16 else ""
        out[f"{prefix}__{i}{suffix}"] = _to_numpy(t, tr)


def _leaf(d, key: str, device) -> torch.Tensor:
    """Leaf ``key`` of the checkpoint as a tensor on ``device`` (a bf16 leaf
    from its ``__bf16`` bit pattern)."""
    if key in d:
        return torch.from_numpy(np.array(d[key])).to(device)
    bits = np.array(d[key + "__bf16"]).view(np.int16)
    return torch.from_numpy(bits).view(torch.bfloat16).to(device)


def save_checkpoint(path: str, grid, params: Dict[str, Any], opt_state: OptState,
                    iters: int) -> None:
    """Full training checkpoint: map structure + params + optimizer state."""
    out: Dict[str, np.ndarray] = {"iters": np.int64(iters)}
    for k, v in grid.state_dict().items():
        out["grid_" + k] = np.asarray(v)
    _flatten("params", _params_tree(params), out)
    _flatten("optm", _moments_tree(opt_state.m), out)
    _flatten("optv", _moments_tree(opt_state.v), out)
    out["optstep"] = np.asarray(opt_state.step, np.int32)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    # uncompressed, as the JAX package and the reference's torch.save write it
    np.savez(path, **out)


def load_checkpoint(path: str, params_like: Dict[str, Any],
                    opt_state_like: Optional[OptState] = None, device=None):
    """Restore (grid, params, opt_state, iters) from a checkpoint of either
    package.

    ``params_like`` gives the structure: its decoders are loaded in place
    and returned; the feature tables come from the checkpoint's grid (float32,
    on ``device``, by default the decoders' device).  The moments are read
    when ``opt_state_like`` is given and the file has them (their feature
    tables at the saved capacity: ``cli.common.pad_opt_state_features``
    grows them)."""
    from ..ops.hashgrid import HashGridHost

    if device is None:
        device = params_like["sigma"].device
    d = np.load(path, allow_pickle=False)
    grid_state = {k[len("grid_"):]: d[k] for k in d.files if k.startswith("grid_")}
    grid = HashGridHost.from_state_dict(grid_state, device=device)

    n_feat = len(params_like[FEATURES])

    @torch.no_grad()
    def load_dense(prefix, tree):
        # the leaves after the feature tables, copied into the tensors in place
        for i, (t, tr) in enumerate(_flatten_tree(tree)[n_feat:], start=n_feat):
            v = _leaf(d, f"{prefix}__{i}", device)
            t.copy_(v.t() if tr else v)

    load_dense("params", _params_tree(params_like))
    # the feature tables come from the grid (authoritative shapes)
    params = dict(params_like, features=list(grid.features))

    opt_state = None
    if opt_state_like is not None and any(k.startswith("optm__") for k in d.files):

        def moments(prefix, like):
            load_dense(prefix, _moments_tree(like))
            flat = {k: v for k, v in like.items() if k != FEATURES}
            flat[FEATURES] = [_leaf(d, f"{prefix}__{i}", device) for i in range(n_feat)]
            return flat

        opt_state = OptState(m=moments("optm", opt_state_like.m),
                             v=moments("optv", opt_state_like.v),
                             step=int(d["optstep"]))
    return grid, params, opt_state, int(d["iters"])


def save_decoders(path: str, params: Dict[str, Any]) -> None:
    """Decoders-only export (utils/tools.py:216-230), keys ``geo.w0`` etc. in
    the JAX package's layout, so they load without a params skeleton."""
    out: Dict[str, np.ndarray] = {}
    for grp in ("geo", "sem"):
        if grp in params:
            named = params[grp].state_dict()
            for leaf, (name, tr) in _decoder_leaves(named).items():
                out[f"{grp}.{leaf}"] = _to_numpy(named[name], tr)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(path, **out)


def load_decoders(path: str, params: Optional[Dict[str, Any]] = None,
                  device="cuda") -> Dict[str, Any]:
    """Decoders of a decoders-only export, or of the reference's ``.pth``
    checkpoint (its ``geo_decoder`` and, where present, ``sem_decoder``; a
    bare state dict gives both, as in the JAX package), as :class:`Decoder`
    modules on ``device``, into (a copy of) ``params`` or a fresh dict."""
    new = dict(params or {})
    if path.endswith(".pth"):
        from ..models.decoder import load_torch_decoder

        new["geo"] = load_torch_decoder(path, "geo_decoder", device)
        try:
            new["sem"] = load_torch_decoder(path, "sem_decoder", device)
        except KeyError:
            pass
        return new
    d = np.load(path, allow_pickle=False)
    for grp in ("geo", "sem"):
        leaves = {k.split(".", 1)[1]: d[k] for k in d.files if k.startswith(grp + ".")}
        if leaves:
            new[grp] = decoder_from_jax(leaves, device)
    return new
