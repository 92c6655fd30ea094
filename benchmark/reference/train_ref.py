"""Plain PyTorch reference of SHINE mapping's batch training step.

Written from the published method (SHINE-Mapping, ICRA 2023, and its
reference code's model/feature_octree.py, model/decoder.py, utils/loss.py
and utils/tools.py) in float32, with no kernel, cache or batching of its own:

* the octree: at each featured level, the nodes that hold a surface sample
  (``weight > 0``) of the pool and their 8 corners, laid out in ascending
  corner-key order (its own rows, not the program's);
* the per-level lookup of a point's node, the smoothstep-polynomial
  trilinear weights of its 8 corners, a miss contributing nothing;
* the decoder MLP (ReLU hidden layers, a linear SDF head);
* the loss: BCE of the logits against sigmoid(label / sigma), plus
  ``weight_e`` times the eikonal term (1 - |d pred / d x| sigma)^2 over the
  surface samples, whose gradient needs the second-order backward;
* Adam (betas 0.9, 0.99, eps 1e-15, the step's bias corrections) on every
  leaf, dense over the tables' rows, weight decay added to the decoders'
  gradients, level i of the tables at ``lr * lr_level_reduce_ratio**i``.

It imports nothing of the program.  ``tf32`` computes its matrix products
in TF32 (the control); ``half_batch`` takes each step's loss over the first
half of the batch (a planted fault).
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

OFFSETS = [((i >> 2) & 1, (i >> 1) & 1, i & 1) for i in range(8)]  # bit 2 x, 1 y, 0 z
B1, B2 = 0.9, 0.99


def pack(q: torch.Tensor) -> torch.Tensor:
    q = q.to(torch.int64)
    return (q[..., 0] << 32) | (q[..., 1] << 16) | q[..., 2]


def quantize(x: torch.Tensor, level: int) -> torch.Tensor:
    res = 2 ** level
    return torch.clamp(torch.floor((x * 0.5 + 0.5) * res), 0, res - 1).to(torch.int64)


def build_structure(surface: torch.Tensor, levels) -> list:
    """Per level (node keys, corner keys), each sorted ascending."""
    off = torch.tensor(OFFSETS, dtype=torch.int64, device=surface.device)
    out = []
    for level in levels:
        nodes = torch.unique(pack(quantize(surface, level)))
        q = torch.stack([(nodes >> 32) & 0xFFFF, (nodes >> 16) & 0xFFFF, nodes & 0xFFFF], 1)
        corners = torch.unique(pack(q[:, None, :] + off[None]))
        out.append((nodes, corners))
    return out


def lookup(coords: torch.Tensor, level: int, nodes: torch.Tensor, corners: torch.Tensor):
    """(found (B,), rows (B, 8) into ``corners``; a miss's rows are 0)."""
    q = quantize(coords.detach(), level)
    key = pack(q)
    pos = torch.searchsorted(nodes, key).clamp(max=nodes.numel() - 1)
    found = nodes[pos] == key
    off = torch.tensor(OFFSETS, dtype=torch.int64, device=coords.device)
    ck = pack(q[:, None, :] + off[None])
    rows = torch.searchsorted(corners, ck).clamp(max=corners.numel() - 1)
    return found, torch.where(found[:, None], rows, 0)


def corner_weights(x: torch.Tensor, level: int, poly: bool) -> torch.Tensor:
    c = (2.0 ** level) * (x * 0.5 + 0.5)
    d = c - torch.floor(c)
    if poly:
        d = 3.0 * d * d - 2.0 * d * d * d
    t = [d[:, 0], d[:, 1], d[:, 2]]
    o = [1.0 - t[0], 1.0 - t[1], 1.0 - t[2]]
    return torch.stack([(t[0] if a else o[0]) * (t[1] if b else o[1]) * (t[2] if c_ else o[2])
                        for a, b, c_ in OFFSETS], dim=-1)


class ReferenceTrainer:
    """The training state (leaves by the published names, the tables as
    ``features.<i>``) and its steps."""

    def __init__(self, spec: dict, structure: list, tables: list, decoders: dict,
                 tf32: bool = False, half_batch: bool = False):
        self.s = spec
        self.structure = structure
        self.p = {f"features.{i}": t.clone() for i, t in enumerate(tables)}
        self.p.update({k: v.clone() for k, v in decoders.items()})
        self.p["sigma"] = torch.ones((), dtype=torch.float32, device=tables[0].device)
        self.m = {k: torch.zeros_like(v) for k, v in self.p.items()}
        self.v = {k: torch.zeros_like(v) for k, v in self.p.items()}
        self.t = 0
        self.tf32 = tf32
        self.half_batch = half_batch

    @contextlib.contextmanager
    def _precision(self):
        old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = self.tf32
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old

    def _sdf(self, feat: torch.Tensor) -> torch.Tensor:
        h = feat
        for i in range(self.s["geo_mlp_level"]):
            h = torch.relu(F.linear(h, self.p[f"geo.layers.{i}.weight"],
                                    self.p.get(f"geo.layers.{i}.bias")))
        return F.linear(h, self.p["geo.lout.weight"], self.p.get("geo.lout.bias"))[:, 0]

    def loss(self, batch: dict) -> torch.Tensor:
        s = self.s
        coord = batch["coord"].detach().requires_grad_(s["eikonal"])
        feat = None
        for i, level in enumerate(s["levels"]):
            found, rows = lookup(coord, level, *self.structure[i])
            w = corner_weights(coord, level, s["poly"])
            w = torch.where(found[:, None], w, torch.zeros_like(w))
            part = torch.einsum("nc,ncd->nd", w, self.p[f"features.{i}"][rows])
            feat = part if feat is None else feat + part
        pred = self._sdf(feat)
        x, target = pred, torch.sigmoid(batch["sdf_label"] / s["sigma_sigmoid"])
        bce = torch.mean(torch.clamp(x, min=0.0) - x * target
                         + torch.log1p(torch.exp(-torch.abs(x))))
        if not s["eikonal"]:
            return bce
        (g,) = torch.autograd.grad(pred.sum(), coord, create_graph=True)
        g = g * s["sigma_sigmoid"]
        sq = torch.sum(g * g, dim=-1)
        norm = torch.where(sq > 0, torch.sqrt(torch.where(sq > 0, sq, torch.ones_like(sq))),
                           torch.zeros_like(sq))
        surf = (batch["weight"] > 0).to(norm.dtype)
        eik = torch.sum((1.0 - norm) ** 2 * surf) / torch.clamp(surf.sum(), min=1.0)
        return bce + s["weight_e"] * eik

    def step(self, batch: dict):
        """One step on ``batch``; returns (loss, {leaf: the gradient Adam
        took})."""
        s = self.s
        if self.half_batch:
            batch = {k: v[: v.shape[0] // 2] for k, v in batch.items()}
        for p in self.p.values():
            p.requires_grad_(True)
            p.grad = None
        with self._precision():
            total = self.loss(batch)
            total.backward()
        self.t += 1
        bc1, bc2 = 1.0 - B1 ** self.t, 1.0 - B2 ** self.t
        lr = s["lr"] * s["lr_decay"] ** sum(int(self.t - 1 >= d) for d in s["lr_decay_step"])
        grads = {}
        with torch.no_grad():
            for k, p in self.p.items():
                g = torch.zeros_like(p) if p.grad is None else p.grad
                p.grad = None
                p.requires_grad_(False)
                if k.startswith(("geo.", "sem.")):
                    g = g + s["weight_decay"] * p
                    lr_k = lr
                elif k.startswith("features."):
                    lr_k = lr * s["lr_level_ratio"] ** int(k.split(".")[1])
                else:
                    lr_k = lr
                self.m[k].mul_(B1).add_((1.0 - B1) * g)
                self.v[k].mul_(B2).add_((1.0 - B2) * (g * g))
                p.sub_(lr_k * (self.m[k] / bc1) / (torch.sqrt(self.v[k] / bc2) + s["eps"]))
                grads[k] = g
        return float(total.detach()), grads


def spec_of(cfg) -> dict:
    """The configuration's values the step reads."""
    return dict(
        levels=[cfg.tree_level_world - i for i in range(cfg.tree_level_feat)],
        poly=bool(cfg.poly_int_on), geo_mlp_level=int(cfg.geo_mlp_level),
        sigma_sigmoid=cfg.logistic_gaussian_ratio * cfg.sigma_sigmoid_m * cfg.scale,
        eikonal=bool(cfg.ekional_loss_on), weight_e=float(cfg.weight_e), lr=float(cfg.lr),
        lr_decay=float(cfg.lr_iters_reduce_ratio), lr_decay_step=list(cfg.lr_decay_step),
        lr_level_ratio=float(cfg.lr_level_reduce_ratio), weight_decay=float(cfg.weight_decay),
        eps=float(cfg.adam_eps), bs=int(cfg.bs))


def norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tensors.items()}


def median(values) -> float:
    v = sorted(values)
    n = len(v)
    return 0.5 * (v[(n - 1) // 2] + v[n // 2]) if n else math.nan
