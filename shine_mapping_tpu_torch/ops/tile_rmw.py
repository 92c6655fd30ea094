"""In-place read-modify-write of whole 128-float table rows.

Port of the TPU kernel K7, ``rmw_kernel`` of ``experiments/pallas_tile_rmw.py``
(``table[tiles[i], :] += deltas[i, :]`` for sorted unique ``tiles`` into a
(T, 128) float32 table, updated in place through a 16-deep DMA pipeline).
:func:`tile_rmw` launches the CUDA kernel of ``csrc/tile_rmw.cu`` on CUDA
tensors and runs :func:`tile_rmw_plain` (``index_add_``) on CPU tensors; there
is no fallback.  Rows must be unique, as the TPU kernel assumes: the kernel
gives two jobs on one row no order.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from . import cuda_build

WIDTH = 128  # floats per table row (512 bytes)

# launches of the CUDA kernel; chip_smoke.py zeroes and reads it around the
# kernel-study path
LAUNCHES: Dict[str, int] = {"tile_rmw": 0}


def reset_launch_counts() -> None:
    LAUNCHES["tile_rmw"] = 0


def _check(table, tiles, deltas):
    if table.dtype != torch.float32 or table.dim() != 2 or table.shape[1] != WIDTH:
        raise ValueError(f"table must be a float32 (T, {WIDTH}) tensor")
    if tiles.dtype != torch.int32 or tiles.dim() != 1:
        raise ValueError("tiles must be an int32 (N,) tensor")
    if deltas.dtype != torch.float32 or tuple(deltas.shape) != (tiles.shape[0], WIDTH):
        raise ValueError(f"deltas must be a float32 (N, {WIDTH}) tensor")
    if not (table.is_contiguous() and tiles.is_contiguous() and deltas.is_contiguous()):
        raise ValueError("table, tiles and deltas must be contiguous")
    if not table.device == tiles.device == deltas.device:
        raise ValueError("table, tiles and deltas must share a device")


@torch.no_grad()
def tile_rmw_plain(table: torch.Tensor, tiles: torch.Tensor,
                   deltas: torch.Tensor) -> torch.Tensor:
    """The plain torch version (any device), in place."""
    return table.index_add_(0, tiles.long(), deltas)


@torch.no_grad()
def tile_rmw(table: torch.Tensor, tiles: torch.Tensor, deltas: torch.Tensor) -> torch.Tensor:
    """``table[tiles[i]] += deltas[i]`` in place; returns ``table``."""
    _check(table, tiles, deltas)
    if table.device.type == "cpu":
        return tile_rmw_plain(table, tiles, deltas)
    if table.device.type != "cuda":
        raise ValueError(f"tile_rmw runs on cuda (or cpu), not {table.device}")
    fn = cuda_build.load("tile_rmw").tile_rmw
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_longlong,
                                                ctypes.c_void_p]
        fn.restype = ctypes.c_int
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        err = fn(table.data_ptr(), tiles.data_ptr(), deltas.data_ptr(), tiles.shape[0],
                 table.shape[0], stream)
    if err != 0:
        raise RuntimeError(f"tile_rmw kernel launch failed: CUDA error {err}")
    LAUNCHES["tile_rmw"] += 1
    return table
