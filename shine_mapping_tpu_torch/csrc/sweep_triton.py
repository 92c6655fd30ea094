"""Triton source of the narrow-block sweep, ``o = p * 0.5 + 1.0``.

Replaces the TPU kernel K6, ``sweep_kernel`` (experiments/exp_narrow_blocks.py:18,
called at :23), which swept a (C, 8) float32 table in (8192, 8) blocks to
measure the rate of unpacked narrow blocks.  On the card the (C, 8) table is
one contiguous buffer, so the kernel sweeps it as a flat array in blocks of
``BLOCK`` elements: one masked 16-byte-per-thread load and store per element.
Bound: memory bandwidth, 8 bytes per element (268 MB at C = 4,194,304, 0.080 ms
at 3.35 TB/s); one multiply-add per element.

This file imports ``triton`` at its top, so it lives outside the package's
modules: ``shine_mapping_tpu_torch/ops/sweep.py`` loads it from its path when
it first launches the kernel, on a machine with the card.
"""

import triton
import triton.language as tl


@triton.jit
def sweep_kernel(p_ptr, o_ptr, n, BLOCK: tl.constexpr):
    offs = tl.program_id(0).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
    mask = offs < n
    x = tl.load(p_ptr + offs, mask=mask)
    tl.store(o_ptr + offs, x * 0.5 + 1.0, mask=mask)
