"""Crop a ground-truth cloud to the intersection of several predictions
(the port's copy of ``shine_mapping_tpu/eval/crop_intersection.py``).

Parity target: reference eval/crop_intersection.py (driver around
eval/eval_utils.py:180-216) — used to build a fair GT for cross-method
comparison tables.

Usage:
    python -m shine_mapping_tpu_torch.eval.crop_intersection gt.ply out_crop.ply \
        pred_a.ply pred_b.ply [...] [--dist_thre 0.1] [--samples 1000000]
"""

from __future__ import annotations

import argparse

from .metrics import crop_intersection


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("gt")
    ap.add_argument("out")
    ap.add_argument("preds", nargs="+")
    ap.add_argument("--dist_thre", type=float, default=0.1)
    ap.add_argument("--samples", type=int, default=1_000_000)
    args = ap.parse_args()
    crop_intersection(args.gt, args.preds, args.out, args.dist_thre, args.samples)


if __name__ == "__main__":
    main()
