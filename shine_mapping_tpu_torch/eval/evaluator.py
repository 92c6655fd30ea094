"""Standalone evaluation driver (the port's copy of
``shine_mapping_tpu/eval/evaluator.py``).

Parity target: reference eval/evaluator.py:5-78 — score a reconstructed
mesh against a ground-truth point cloud with the dataset-specific protocol
(MaiCity: 10 cm threshold, 0.2/2.0 m truncations; Newer College: 20 cm,
0.4/2.0 m), writing a CSV of metrics.

Usage:
    python -m shine_mapping_tpu_torch.eval.evaluator <pred_mesh.ply> <gt_pc.ply> \
        [--dataset maicity|ncd] [--out result.csv]
"""

from __future__ import annotations

import argparse
import csv
import os

from .metrics import eval_mesh

PROTOCOLS = {
    # eval/evaluator.py:47-50
    "maicity": dict(
        down_sample_res=0.02, threshold=0.10, truncation_acc=0.20,
        truncation_com=2.0, gt_bbx_mask_on=True,
    ),
    # eval/evaluator.py:53-56
    "ncd": dict(
        down_sample_res=0.02, threshold=0.20, truncation_acc=0.40,
        truncation_com=2.0, gt_bbx_mask_on=True,
    ),
}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("pred_mesh")
    ap.add_argument("gt_pc")
    ap.add_argument("--dataset", default="maicity", choices=sorted(PROTOCOLS))
    ap.add_argument("--out", default="")
    ap.add_argument("--mesh_sample_point", type=int, default=10_000_000)
    args = ap.parse_args()

    metrics = eval_mesh(
        args.pred_mesh, args.gt_pc,
        mesh_sample_point=args.mesh_sample_point, **PROTOCOLS[args.dataset],
    )
    for k, v in metrics.items():
        print(f"{k}: {v}")
    if args.out:
        exists = os.path.exists(args.out)
        with open(args.out, "a", newline="") as f:
            w = csv.writer(f)
            if not exists:
                w.writerow(["mesh"] + list(metrics.keys()))
            w.writerow([args.pred_mesh] + list(metrics.values()))


if __name__ == "__main__":
    main()
