"""K3 study: the one-hot fused scatter + Adam kernel against a scatter and a
dense Adam sweep in torch, at bench scale (C = 4,194,304 rows of 8, 65,536
sorted entries), over the (tb, w) sweep of experiments/exp_fused_adam.py.

    python -m shine_mapping_tpu_torch.experiments.exp_fused_adam [--device cpu --small]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from shine_mapping_tpu_torch.experiments import device_of, describe, log, parser, timed_ms
from shine_mapping_tpu_torch.ops import onehot_adam as oa

B1, B2, EPS = oa.B1, oa.B2, oa.EPS
D = 8
TILES = ((256, 256), (128, 128), (512, 512), (256, 512))


def scatter_adam(p, m, v, rows, grads, lr, bc1, bc2):
    """Reference: a dense gradient table by ``index_add_``, then a dense
    Adam sweep (the script's ``xla_scatter_adam``)."""
    g = torch.zeros_like(p).index_add_(0, rows.long(), grads)
    m = B1 * m + (1 - B1) * g
    v = B2 * v + (1 - B2) * g * g
    p = p - lr * (m / bc1) / (torch.sqrt(v / bc2) + EPS)
    return p, m, v


def main(argv=None) -> int:
    args = parser(__doc__).parse_args(argv)
    dev = device_of(args)
    log(f"devices: {describe(dev)}")
    C = 1 << 16 if args.small else 1 << 22
    M = 2048 if args.small else 65536
    rng = np.random.default_rng(0)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    # --- correctness (small) ---
    Cs = 1 << 14
    rows_s = np.sort(rng.integers(0, Cs - 1, 4096)).astype(np.int32)
    rows_s[-64:] = Cs - 1  # trashbin tail
    grads_s = rng.normal(size=(4096, D)).astype(np.float32)
    grads_s[-64:] = 0.0
    p0 = rng.normal(size=(Cs, D)).astype(np.float32)
    m0 = rng.normal(size=(Cs, D)).astype(np.float32) * 0.1
    v0 = np.abs(rng.normal(size=(Cs, D))).astype(np.float32) * 0.01
    lr, bc1, bc2 = 0.01, 1 - B1 ** 5, 1 - B2 ** 5
    ref = scatter_adam(t(p0), t(m0), t(v0), t(rows_s), t(grads_s), lr, bc1, bc2)
    got = oa.fused_adam_onehot(t(p0), t(m0), t(v0), t(rows_s), t(grads_s), lr, bc1, bc2,
                               tb=64, w=256)
    errs = {}
    for name, a, b in zip("pmv", ref, got):
        errs[name] = float((a - b).abs().max())
        log(f"correctness {name}: max|err| = {errs[name]:.3e}")
    assert all(e < 1e-5 for e in errs.values()), errs
    log("correctness OK")

    # --- primitives at bench scale ---
    rows = t(np.sort(rng.integers(0, C - 1, M)).astype(np.int32))
    grads = t(rng.normal(size=(M, D)).astype(np.float32))
    p = t(rng.normal(size=(C, D)).astype(np.float32))
    m = torch.zeros((C, D), device=dev)
    v = torch.zeros((C, D), device=dev)
    rows_l = rows.long()
    scaled = grads * 1e-6
    tmp = p.clone()
    ts = timed_ms(lambda: tmp.index_add_(0, rows_l, scaled), dev, args.iters, args.reps)
    log(f"torch index_add_: {ts:.3f} ms ({ts / M * 1e6:.1f} ns/entry)")
    del tmp

    state = [p, m, v]

    def plain_full():
        state[:] = scatter_adam(*state, rows, grads, lr, bc1, bc2)

    t_plain = timed_ms(plain_full, dev, args.iters, args.reps)
    log(f"torch index_add_+adam sweep: {t_plain:.3f} ms/level")

    perm = [t(rng.permutation(rows.cpu().numpy())), grads]

    def sort_gather():
        o = torch.argsort(perm[0])
        perm[:] = [perm[0][o], perm[1][o]]

    t_sg = timed_ms(sort_gather, dev, args.iters, args.reps)
    log(f"argsort + ({M // 1024}k,8) perm gather: {t_sg:.3f} ms")

    # --- the one-hot kernel at bench scale ---
    prow = (rows // oa.PACK).to(torch.int32)
    for tb, w in TILES:
        Mpad = oa.padded_len(M, w)
        offs = oa.window_offsets(prow, C * D // 128 // tb, tb, w, Mpad)
        ok = bool(oa.windows_ok(prow, offs, tb, w))
        state = [p, m, v]

        def fused_full(tb=tb, w=w):
            state[:] = oa.fused_adam_onehot(*state, rows, grads, lr, bc1, bc2, tb=tb, w=w)

        tp = timed_ms(fused_full, dev, args.iters, args.reps)
        log(f"onehot fused tb={tb} w={w}: {tp:.3f} ms/level (torch {t_plain:.3f}), "
            f"windows_ok {ok}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
