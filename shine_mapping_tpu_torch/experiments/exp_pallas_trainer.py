"""K5 study: the round-3 gather-hazard runs of experiments/exp_pallas_trainer.py
(``main2``), at bench scale (one level of C = 4,194,304 rows of 8, 65,536
entries, a (8192, 8) corner gather per step, tiles from ``choose_tiles``):

  gather_nodep : a gather from p whose result does not feed the update
                 (K1's step, the one-hot kernel's ``dot_bf16`` variant)
  pcopy_f32    : the update also writes a float32 copy of the new p, which
                 the next step's gather reads (K5, in place)
  pcopy_bf16   : the same with a bfloat16 copy

    python -m shine_mapping_tpu_torch.experiments.exp_pallas_trainer [--device cpu --small]

The script's ``main()`` bisection is not ported: it reaches only K1 through
the JAX wrapper's XLA cond and lane prep (see ROADMAP.md).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from shine_mapping_tpu_torch.experiments import device_of, describe, log, parser, timed_ms
from shine_mapping_tpu_torch.ops import onehot_adam as oa


def main(argv=None) -> int:
    args = parser(__doc__).parse_args(argv)
    dev = device_of(args)
    log(f"devices: {describe(dev)}")
    C, D = (1 << 16 if args.small else 1 << 22), 8
    M = 2048 if args.small else 65536
    B = M // 8  # 8192 samples x 8 corners at bench scale
    R = C * D // 128
    tb, w = oa.choose_tiles(C, D, M)
    log(f"tb={tb} w={w}")
    rng = np.random.default_rng(0)
    rows_np = rng.integers(0, C - 1, M).astype(np.int32)
    rows_sorted = torch.from_numpy(np.sort(rows_np)).to(dev)
    prow = (rows_sorted // oa.PACK).to(torch.int32)
    prow_p = oa.padded_prow(prow, w)
    Mpad = prow_p.shape[1]
    offs = oa.window_offsets(prow, R // tb, tb, w, Mpad)
    log(f"windows_ok: {bool(oa.windows_ok(prow, offs, tb, w))}")
    g_hi = torch.zeros((Mpad, 128), dtype=torch.bfloat16, device=dev)
    g_lo = torch.zeros((Mpad, 128), dtype=torch.bfloat16, device=dev)
    scal = torch.tensor([1e-4, 0.5, 0.5, 0.0], device=dev)
    idx = torch.from_numpy(rows_np[: B * 8].reshape(B, 8)).long().to(dev)

    def zeros(dtype=torch.float32):
        return torch.zeros((R, 128), dtype=dtype, device=dev)

    state = [zeros(), zeros(), zeros(), torch.zeros((), device=dev)]

    def gather_nodep():
        # the gather's result does not feed the kernel: if this is fast, the
        # slow part is the dependency, not the gather
        p, m, v, acc = state
        G = p.view(C, D)[idx]
        out = oa.fused_adam_onehot_variant(p.view(C, D), m.view(C, D), v.view(C, D), prow_p,
                                           g_hi, g_lo, offs, scal, tb, w, "dot_bf16")
        state[:] = [t.view(R, 128) for t in out] + [acc + G.sum()]

    ms = timed_ms(gather_nodep, dev, args.iters, args.reps)
    log(f"{'gather_nodep':14s}: {ms:8.3f} ms/iter")

    for dt, name in ((torch.float32, "pcopy_f32"), (torch.bfloat16, "pcopy_bf16")):
        state = [zeros(), zeros(), zeros(), zeros(dt)]

        def pcopy(dt=dt):
            p, m, v, pc = state
            G = pc.view(C, D)[idx]  # reads the COPY
            g2h = g_hi + (G.float().sum() * 1e-12).to(torch.bfloat16)
            state[:] = oa.fused_adam_onehot_copy(p, m, v, prow_p, g2h, g_lo, offs, scal, tb,
                                                 w, dt)

        ms = timed_ms(pcopy, dev, args.iters, args.reps)
        log(f"{name:14s}: {ms:8.3f} ms/iter")
    return 0


if __name__ == "__main__":
    sys.exit(main())
