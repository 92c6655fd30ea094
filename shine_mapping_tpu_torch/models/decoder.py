"""Shallow MLP decoder (geometry + semantics) as a torch ``nn.Module``.

Port of ``shine_mapping_tpu/models/decoder.py`` (reference ``Decoder``,
model/decoder.py:9-101): a ``mlp_level``-deep ReLU MLP over the summed grid
feature with a 1-dim SDF head (sign-flipped vs. the true SDF) and a
``sem_class_count+1`` log-softmax semantic head; with ``time_conditioned``
the timestamp is appended to the input (model/decoder.py:65-81).

Submodule names follow the reference's state dict (``layers.{i}``, ``lout``,
``nclass_out``), so a reference ``.pth`` loads with ``load_state_dict``.
``nn.Linear`` stores its weight ``(out, in)`` where the JAX package's
``w{i}`` is ``(in, out)``: ``interop.py`` transposes on carry-over.
:func:`load_torch_decoder` reads the reference's ``.pth`` decoders.
"""

from __future__ import annotations

import math

import torch
from torch import nn


class Decoder(nn.Module):
    def __init__(
        self,
        feature_dim: int,
        hidden_dim: int = 32,
        mlp_level: int = 2,
        sem_class_count: int = 20,
        bias_on: bool = True,
        generator: torch.Generator | None = None,
        device="cuda",
        time_conditioned: bool = False,
    ):
        super().__init__()
        dims = [feature_dim + (1 if time_conditioned else 0)] + [hidden_dim] * mlp_level
        kw = dict(bias=bias_on, device=device, dtype=torch.float32)
        self.layers = nn.ModuleList(
            nn.Linear(dims[i], dims[i + 1], **kw) for i in range(mlp_level)
        )
        self.lout = nn.Linear(hidden_dim, 1, **kw)
        self.nclass_out = nn.Linear(hidden_dim, sem_class_count + 1, **kw)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        """torch.nn.Linear's default init, U(-1/sqrt(fan_in), 1/sqrt(fan_in))
        for weight and bias, drawn from ``generator``.  The JAX package
        reproduces the same distribution (decoder.init_decoder_params); the
        two frameworks draw different numbers from a seed, so tests carry
        weights across with interop.py instead."""
        for lin in [*self.layers, self.lout, self.nclass_out]:
            bound = 1.0 / math.sqrt(lin.in_features)
            lin.weight.uniform_(-bound, bound, generator=generator)
            if lin.bias is not None:
                lin.bias.uniform_(-bound, bound, generator=generator)

    def hidden(self, feature: torch.Tensor) -> torch.Tensor:
        h = feature
        for lin in self.layers:
            h = torch.relu(lin(h))
        return h

    def sdf(self, feature: torch.Tensor) -> torch.Tensor:
        """(N,D) feature -> (N,) sdf logits (opposite sign to true SDF).

        Reference model/decoder.py:49-63."""
        return self.lout(self.hidden(feature))[..., 0]

    def time_conditioned_sdf(self, feature: torch.Tensor, ts: torch.Tensor) -> torch.Tensor:
        """SDF conditioned on a per-sample timestamp (model/decoder.py:65-81)."""
        return self.sdf(torch.cat([feature, ts.reshape(-1, 1).to(feature.dtype)], dim=1))

    def occupancy(self, feature: torch.Tensor) -> torch.Tensor:
        """Sigmoid-squashed sdf logits (model/decoder.py:84-86)."""
        return torch.sigmoid(self.sdf(feature))

    def sem_label_prob(self, feature: torch.Tensor) -> torch.Tensor:
        """(N, n_class+1) log-softmax semantic logits (model/decoder.py:89-97)."""
        return torch.log_softmax(self.nclass_out(self.hidden(feature)), dim=1)

    def sem_label(self, feature: torch.Tensor) -> torch.Tensor:
        """Argmax semantic class (model/decoder.py:99-101)."""
        return torch.argmax(self.sem_label_prob(feature), dim=1)


def decoder_from_state_dict(state, device="cuda") -> Decoder:
    """A :class:`Decoder` holding a reference ``Decoder.state_dict()``
    (``layers.{i}``, ``lout``, ``nclass_out``; weights ``(out, in)``), its
    widths read from the weights' shapes.  A decoder without biases gets
    zero biases, as the JAX package's loader gives it."""
    n = sum(1 for k in state if k.startswith("layers.") and k.endswith(".weight"))
    w0 = state["layers.0.weight"]
    n_sem = state["nclass_out.weight"].shape[0] - 1 if "nclass_out.weight" in state else 20
    dec = Decoder(int(w0.shape[1]), int(w0.shape[0]), n, n_sem, True, device=device)
    with torch.no_grad():
        for name, p in dec.named_parameters():
            if name in state:
                p.copy_(torch.as_tensor(state[name], dtype=torch.float32))
            elif name.endswith(".bias") and not name.startswith("nclass_out"):
                p.zero_()
    return dec


def load_torch_decoder(path: str, key: str = "geo_decoder", device="cuda") -> Decoder:
    """The decoder of a reference ``.pth`` checkpoint (the key ``key`` of the
    saved dict, or the file itself when it is a bare state dict; JAX
    ``models.decoder.load_torch_decoder``)."""
    loaded = torch.load(path, map_location="cpu", weights_only=False)
    if key in loaded:
        state = loaded[key]
    elif any(hasattr(v, "detach") for v in loaded.values()):
        state = loaded
    else:
        raise KeyError(f"{key} not found in {path}")
    return decoder_from_state_dict({k: v.detach() for k, v in state.items()}, device)
