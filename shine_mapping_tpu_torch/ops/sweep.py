"""Narrow-block elementwise sweep, ``o = p * 0.5 + 1.0``, as a Triton kernel.

Port of the TPU kernel K6, ``sweep_kernel`` of
``experiments/exp_narrow_blocks.py`` (a Pallas pass over a (C, 8) float32
table in (8192, 8) blocks).  :func:`sweep` launches the Triton kernel of
``csrc/sweep_triton.py`` on a CUDA tensor and runs :func:`sweep_plain` on a
CPU tensor; there is no fallback.  ``triton`` is imported, and the kernel
compiled, at the first launch, with Triton's cache under ``csrc/build/``
(listed in ``.gitignore``).  The output is a new tensor, as the TPU kernel's.
"""

from __future__ import annotations

import importlib.util
import os
from typing import Dict

import torch

from .cuda_build import BUILD_DIR, CSRC_DIR

BLOCK = 4096  # elements per program
NUM_WARPS = 8

# launches of the Triton kernel; chip_smoke.py zeroes and reads it around
# the kernel-study path
LAUNCHES: Dict[str, int] = {"sweep": 0}

_kernel = None


def reset_launch_counts() -> None:
    LAUNCHES["sweep"] = 0


def sweep_plain(p: torch.Tensor) -> torch.Tensor:
    """The plain torch version (any device)."""
    return p * 0.5 + 1.0


def _load_kernel():
    global _kernel
    if _kernel is None:
        os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(BUILD_DIR, "triton"))
        path = os.path.join(CSRC_DIR, "sweep_triton.py")
        spec = importlib.util.spec_from_file_location("shine_sweep_triton", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _kernel = mod.sweep_kernel
    return _kernel


def sweep(p: torch.Tensor) -> torch.Tensor:
    """``p * 0.5 + 1.0`` of a contiguous float32 tensor (the JAX script's
    (C, 8) table), as a new tensor."""
    if p.dtype != torch.float32 or not p.is_contiguous():
        raise ValueError("sweep takes a contiguous float32 tensor")
    if p.device.type == "cpu":
        return sweep_plain(p)
    if p.device.type != "cuda":
        raise ValueError(f"sweep runs on cuda (or cpu), not {p.device}")
    kernel = _load_kernel()
    out = torch.empty_like(p)
    n = p.numel()
    grid = (max(1, -(-n // BLOCK)),)
    if p.get_device() == torch.cuda.current_device():  # Triton launches on the current device
        kernel[grid](p, out, n, BLOCK=BLOCK, num_warps=NUM_WARPS)
    else:
        with torch.cuda.device(p.device):
            kernel[grid](p, out, n, BLOCK=BLOCK, num_warps=NUM_WARPS)
    LAUNCHES["sweep"] += 1
    return out
