#!/usr/bin/env python3
"""The JAX package's incremental driver on the CPU on chip_smoke.py phase 7's
world and runs: the F-score its final mesh reaches, the anchor that
``chip_smoke.JAX_INCRE_FSCORE`` holds the port's runs on the card to.

    JAX_PLATFORMS=cpu python3 scripts/jax_incre_reference.py [--runs C,D,E] [--seeds 42,1,2]

Writes the synthetic world (20 frames of 64 x 1,024 rays,
``chip_smoke.write_synth_sequence``) into a temporary directory, runs
``shine_mapping_tpu.cli.shine_incre`` with each run's config and cuts
(``chip_smoke.incre_config``), scores the last frame's mesh with phase 6's
``EVAL_KW`` and prints one line per run and seed (``setting.seed``: the
config's 42 and others, for the spread of a single run) and a JSON object
of each run's F-scores and their mean.
Takes tens of minutes on a CPU (run D's pool reaches millions of samples).
"""

import argparse
import json
import os
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import chip_smoke  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", default="C,D,E")
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--seeds", default="42")
    args = ap.parse_args()
    from shine_mapping_tpu.cli import shine_incre
    from shine_mapping_tpu.config import SHINEConfig
    from shine_mapping_tpu_torch.eval.metrics import eval_mesh

    out = {}
    with tempfile.TemporaryDirectory(prefix="jax_incre_") as tmp:
        world = os.path.join(tmp, "world")
        _, gt_path = chip_smoke.write_synth_sequence(world, args.frames)
        for run, seed in [(r, int(s)) for r in chip_smoke.INCRE_RUNS
                          for s in args.seeds.split(",")]:
            label = run[0]
            if label not in args.runs.split(","):
                continue
            cfg, line = chip_smoke.incre_config(SHINEConfig, run, world,
                                                os.path.join(tmp, label), args.frames)
            cfg.seed = seed
            print(line + f"; seed {seed}", flush=True)
            ratio = shine_incre.PRECOMPUTE_WORK_RATIO
            if run[3]:
                shine_incre.PRECOMPUTE_WORK_RATIO = 0.0
            t0 = time.perf_counter()
            try:
                run_path, _, _ = shine_incre.run_shine_mapping_incremental(cfg=cfg)
            finally:
                shine_incre.PRECOMPUTE_WORK_RATIO = ratio
            m = eval_mesh(os.path.join(run_path, f"mesh/mesh_frame_{args.frames}.ply"),
                          gt_path, **chip_smoke.EVAL_KW)
            out.setdefault(label, []).append(round(m["F-score (%)"], 3))
            print(f"[jax incre] run {label}, seed {seed}: F-score {m['F-score (%)']:.3f} %, precision "
                  f"{m['Precision [Accuracy] (%)']:.3f} %, recall "
                  f"{m['Recall [Completeness] (%)']:.3f} %, Chamfer-L1 "
                  f"{m['Chamfer_L1 (m)']:.4f} m; {time.perf_counter() - t0:.0f} s on the CPU",
                  flush=True)
    print(json.dumps({k: {"F-score": v, "mean": round(sum(v) / len(v), 3)}
                      for k, v in out.items()}))


if __name__ == "__main__":
    main()
