"""The weights a run starts from, made by the benchmark from the seed and
handed alike to the program and to the reference.

A feature-table row's initial value is a function of the seed, the octree
level and the row's corner key ``x << 32 | y << 16 | z`` alone (a counter
hash, two uniforms a lane, Box-Muller, times ``feature_std``), so the
reference, which lays out its own rows, draws the same values without the
program's layout.  The decoders' weights and biases are
U(-1/sqrt(fan_in), 1/sqrt(fan_in)), torch.nn.Linear's default, from one draw
of a ``torch.Generator`` on the device, split in the order of
:func:`decoder_layout`.
"""

from __future__ import annotations

import math

import torch

M32 = 0xFFFFFFFF
_CHUNK = 1 << 20


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer finaliser on int64 tensors holding values < 2**32
    (every product stays under 2**59)."""
    x = x ^ (x >> 16)
    x = (x * 0x45D9F3B) & M32
    x = x ^ (x >> 16)
    x = (x * 0x45D9F3B) & M32
    return x ^ (x >> 16)


def table_values(seed: int, level: int, keys: torch.Tensor, dim: int, std: float) -> torch.Tensor:
    """float32 (n, dim) initial rows of the corners ``keys`` (int64, (n,))."""
    dev = keys.device
    base = _mix32(torch.tensor([((seed >> 32) + level * 0x1000193) & M32], device=dev))
    base = _mix32(base ^ (seed & M32))
    lanes = torch.arange(2 * dim, device=dev, dtype=torch.int64) * 0x27D4EB2D & M32
    out = []
    for a in range(0, keys.shape[0], _CHUNK):
        k = keys[a:a + _CHUNK].to(torch.int64)
        h = _mix32(_mix32((k & 0xFFFFFF) ^ base) ^ (k >> 24))
        h = _mix32(h[:, None] ^ lanes[None, :])
        u = (h.double() + 0.5) / 2.0 ** 32
        r = torch.sqrt(-2.0 * torch.log(u[:, 0::2]))
        out.append((r * torch.cos(2.0 * math.pi * u[:, 1::2]) * std).float())
    return torch.cat(out) if out else torch.zeros((0, dim), device=dev)


def decoder_layout(cfg) -> list:
    """(name, shape, fan_in) of every decoder weight and bias, by the
    published decoder's state-dict names (geometry, then semantics)."""
    out = []
    for tag, hidden, level, bias in (("geo", cfg.geo_mlp_hidden_dim, cfg.geo_mlp_level,
                                      cfg.geo_mlp_bias_on),
                                     ("sem", cfg.sem_mlp_hidden_dim, cfg.sem_mlp_level,
                                      cfg.sem_mlp_bias_on)):
        dims = [cfg.feature_dim] + [hidden] * level
        heads = [(f"layers.{i}", dims[i + 1], dims[i]) for i in range(level)]
        heads += [("lout", 1, hidden), ("nclass_out", cfg.sem_class_count + 1, hidden)]
        for name, n_out, n_in in heads:
            out.append((f"{tag}.{name}.weight", (n_out, n_in), n_in))
            if bias:
                out.append((f"{tag}.{name}.bias", (n_out,), n_in))
    return out


def decoder_values(seed: int, layout: list, device) -> dict:
    sizes = [math.prod(shape) for _, shape, _ in layout]
    gen = torch.Generator(device).manual_seed(seed)
    u = torch.rand(sum(sizes), generator=gen, device=device, dtype=torch.float32)
    out = {}
    for (name, shape, fan_in), part in zip(layout, torch.split(u, sizes)):
        bound = 1.0 / math.sqrt(fan_in)
        out[name] = ((part * 2.0 - 1.0) * bound).reshape(shape)
    return out


@torch.no_grad()
def write_into(params: dict, grid, cfg, seed: int) -> None:
    """Put the benchmark's weights into the program's parameters: decoders
    by name, table rows through the grid's corner keys and rows."""
    from shine_mapping_tpu_torch.train.optimizer import dense_params

    dense = dense_params(params)
    for name, val in decoder_values(seed, decoder_layout(cfg), cfg.device).items():
        if tuple(dense[name].shape) != tuple(val.shape):
            raise ValueError(f"{name}: the program holds {tuple(dense[name].shape)}, the "
                             f"configuration gives {tuple(val.shape)}")
        dense[name].copy_(val)
    for i, (hl, feats) in enumerate(zip(grid.host_levels, params["features"])):
        keys = torch.from_numpy(hl.corner_keys_sorted).to(feats.device)
        rows = torch.from_numpy(hl.corner_rows_sorted.astype("int64")).to(feats.device)
        vals = table_values(seed, int(hl.level), keys, feats.shape[1], cfg.feature_std)
        feats.index_copy_(0, rows, vals.to(feats.dtype))
