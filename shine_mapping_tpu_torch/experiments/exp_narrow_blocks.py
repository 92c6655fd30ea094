"""K6 study: the rate of an elementwise sweep over a narrow (C, 8) float32
table, ``o = p * 0.5 + 1.0`` at C = 4,194,304 (experiments/exp_narrow_blocks.py),
as the Triton kernel of ``ops/sweep.py``.

    python -m shine_mapping_tpu_torch.experiments.exp_narrow_blocks [--device cpu --small]
"""

from __future__ import annotations

import sys

import torch

from shine_mapping_tpu_torch.experiments import device_of, parser, timed_ms
from shine_mapping_tpu_torch.ops.sweep import sweep

D = 8


def main(argv=None) -> int:
    args = parser(__doc__).parse_args(argv)
    dev = device_of(args)
    C = 1 << 16 if args.small else 1 << 22
    state = [torch.ones((C, D), device=dev)]

    def step():
        state[0] = sweep(state[0])

    ms = timed_ms(step, dev, args.iters, args.reps)
    gbps = 2 * C * D * 4 / (ms / 1e3) / 1e9
    print(f"narrow-block sweep: {ms:.3f} ms/iter ({gbps:.0f} GB/s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
