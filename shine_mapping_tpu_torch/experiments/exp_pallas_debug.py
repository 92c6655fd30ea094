"""K4 study: what each part of the one-hot fused Adam kernel costs, at bench
scale (C = 4,194,304 rows of 8, 65,536 entries per level), as
experiments/exp_pallas_debug.py bisects it:

  copy      : stream p, m, v in -> out only
  sweep     : p, m, v in -> Adam with g = 0 -> out
  window    : + reading the gradient windows (folded in as sum x 0)
  onehot    : + finding each row's window entries (count x 0)
  dot_bf16  : the full kernel, hi + lo bf16 lane sums (K1's)
  dot_hi    : the full kernel, (hi + lo) summed in f32

    python -m shine_mapping_tpu_torch.experiments.exp_pallas_debug [--device cpu --small]
        [--tb 256] [--w 256] [--variants copy,sweep,window,dot_bf16]

``--tb``, ``--w`` and ``--variants`` take what the script reads from its
environment variables TB, W and VARIANTS, with the same defaults.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from shine_mapping_tpu_torch.experiments import device_of, describe, log, parser, timed_ms
from shine_mapping_tpu_torch.ops import onehot_adam as oa

D = 8


def main(argv=None) -> int:
    ap = parser(__doc__)
    ap.add_argument("--tb", type=int, default=256)
    ap.add_argument("--w", type=int, default=256)
    ap.add_argument("--variants", default="copy,sweep,window,dot_bf16")
    args = ap.parse_args(argv)
    dev = device_of(args)
    log(f"devices: {describe(dev)}")
    C = 1 << 16 if args.small else 1 << 22
    M = 2048 if args.small else 65536
    tb, w = args.tb, args.w
    rng = np.random.default_rng(0)
    rows = torch.from_numpy(np.sort(rng.integers(0, C - 1, M)).astype(np.int32)).to(dev)
    grads = torch.from_numpy(rng.normal(size=(M, D)).astype(np.float32)).to(dev)
    prow_p, g_hi, g_lo, offs = oa.window_inputs(rows, grads, C, tb, w)
    log(f"windows_ok: {bool(oa.windows_ok(prow_p[0, :M], offs, tb, w))}")

    p = torch.from_numpy(rng.normal(size=(C, D)).astype(np.float32)).to(dev)
    m = torch.zeros((C, D), device=dev)
    v = torch.zeros((C, D), device=dev)
    scal = torch.tensor([1e-4, 0.5, 0.5, 0.0], device=dev)

    # correctness of dot_bf16 against a dense step
    po, mo, vo = oa.fused_adam_onehot_variant(p, m, v, prow_p, g_hi, g_lo, offs, scal, tb,
                                              w, "dot_bf16")
    gd = torch.zeros((C, D), device=dev).index_add_(0, rows.long(), grads)
    m_ref = (1 - oa.B1) * gd
    v_ref = (1 - oa.B2) * gd * gd
    p_ref = p - 1e-4 * (m_ref / 0.5) / (torch.sqrt(v_ref / 0.5) + oa.EPS)
    log(f"correctness dot_bf16: p {float((po - p_ref).abs().max()):.3e} "
        f"m {float((mo - m_ref).abs().max()):.3e}")

    for variant in args.variants.split(","):
        state = [p, m, v]

        def step(variant=variant):
            state[:] = oa.fused_adam_onehot_variant(*state, prow_p, g_hi, g_lo, offs, scal,
                                                    tb, w, variant)

        ms = timed_ms(step, dev, args.iters, args.reps)
        log(f"{variant:9s}: {ms:7.3f} ms/level")
    return 0


if __name__ == "__main__":
    sys.exit(main())
