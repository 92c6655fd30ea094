"""K7 study: a read-modify-write of whole 512-byte table rows, applying
32,768 sorted unique row updates to a (262,144, 128) float32 table in place
(experiments/pallas_tile_rmw.py), as the CUDA kernel of ``ops/tile_rmw.py``,
against ``index_add_`` on the same job.

    python -m shine_mapping_tpu_torch.experiments.pallas_tile_rmw [--device cpu --small]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from shine_mapping_tpu_torch.experiments import device_of, parser, timed_ms
from shine_mapping_tpu_torch.ops.tile_rmw import tile_rmw


def main(argv=None) -> int:
    args = parser(__doc__).parse_args(argv)
    dev = device_of(args)
    T = 4096 if args.small else 262144  # table rows (4.2M corner rows / 16)
    N = 512 if args.small else 32768  # row jobs per call
    rng = np.random.default_rng(0)
    table = torch.from_numpy(rng.standard_normal((T, 128)).astype(np.float32)).to(dev)
    tiles = torch.from_numpy(np.sort(rng.choice(T, N, replace=False)).astype(np.int32)).to(dev)
    deltas = torch.from_numpy(rng.standard_normal((N, 128)).astype(np.float32)).to(dev)

    out = tile_rmw(table.clone(), tiles, deltas)
    ref = table.clone()
    ref[tiles.long()] += deltas
    print("correctness max err:", float((out - ref).abs().max()), flush=True)

    acc = table.clone()
    dt = timed_ms(lambda: tile_rmw(acc, tiles, deltas), dev, args.iters, args.reps)
    print(f"tile-RMW {N} tiles (512B): {dt:.3f} ms  ({dt * 1e6 / N:.1f} ns/tile)",
          flush=True)
    rows = tiles.long()
    dt = timed_ms(lambda: acc.index_add_(0, rows, deltas), dev, args.iters, args.reps)
    print(f"torch index_add_ same job: {dt:.3f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
