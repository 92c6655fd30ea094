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

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]
_entry_fn = None  # csrc/tile_rmw.cu's tile_rmw, resolved at the first launch


def reset_launch_counts() -> None:
    LAUNCHES["tile_rmw"] = 0


def c_entry(lib: ctypes.CDLL) -> ctypes._CFuncPtr:
    """``lib.tile_rmw`` with its C signature declared: ``lib`` is the library
    of ``csrc/tile_rmw.cu`` or of another copy of it with the same interface."""
    fn = lib.tile_rmw
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    return fn


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


def launch(table: torch.Tensor, tiles: torch.Tensor, deltas: torch.Tensor, fn=None) -> None:
    """One launch of the kernel (``fn``: another build's :func:`c_entry`) on
    CUDA tensors that :func:`tile_rmw` has checked, on the current stream of
    the table's device; not counted."""
    global _entry_fn
    if fn is None:
        if _entry_fn is None:
            _entry_fn = c_entry(cuda_build.load("tile_rmw"))
        fn = _entry_fn
    dev = table.get_device()
    args = (table.data_ptr(), tiles.data_ptr(), deltas.data_ptr(), tiles.shape[0],
            table.shape[0])
    if dev == torch.cuda.current_device():
        err = fn(*args, torch._C._cuda_getCurrentRawStream(dev))
    else:
        with torch.cuda.device(dev):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(dev))
    if err != 0:
        raise RuntimeError(f"tile_rmw kernel launch failed: CUDA error {err}")


def tile_rmw(table: torch.Tensor, tiles: torch.Tensor, deltas: torch.Tensor) -> torch.Tensor:
    """``table[tiles[i]] += deltas[i]`` in place; returns ``table``."""
    _check(table, tiles, deltas)
    if not table.is_cuda:
        if table.device.type != "cpu":
            raise ValueError(f"tile_rmw runs on cuda (or cpu), not {table.device}")
        return tile_rmw_plain(table, tiles, deltas)
    launch(table, tiles, deltas)
    LAUNCHES["tile_rmw"] += 1
    return table
