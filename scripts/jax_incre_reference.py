#!/usr/bin/env python3
"""The JAX package's incremental driver on the CPU on chip_smoke.py phase 7's
world and runs: the F-score its final mesh reaches, the anchor that
``chip_smoke.JAX_INCRE_FSCORE`` holds the port's runs on the card to; with
``--room``, phase 11's run (l) on the synthetic RGB-D room, the anchor of
``chip_smoke.JAX_ROOM_INCRE_FSCORE``.

    JAX_PLATFORMS=cpu python3 scripts/jax_incre_reference.py [--runs C,D,E] [--seeds 42,1,2]
    JAX_PLATFORMS=cpu python3 scripts/jax_incre_reference.py --room [--seeds 42,1,2]

Writes the synthetic world (20 frames of 64 x 1,024 rays,
``chip_smoke.write_synth_sequence``) into a temporary directory, runs
``shine_mapping_tpu.cli.shine_incre`` with each run's config and cuts
(``chip_smoke.incre_config``), scores the last frame's mesh with phase 6's
``EVAL_KW`` and prints one line per run and seed (``setting.seed``: the
config's 42 and others, for the spread of a single run) and a JSON object
of each run's F-scores and their mean.
Takes tens of minutes on a CPU (run D's pool reaches millions of samples).
``--room`` writes the room (``chip_smoke.write_room``: the sequence, the
port's converter, the exact ground truth of run (l)'s frames), runs
``config/rgbd/rgbd_incre_reg.yaml`` with run (l)'s cuts
(``chip_smoke.surface_incre_config``) and scores its last mesh with
``chip_smoke.ROOM_EVAL_KW``; under a minute a seed.
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
    ap.add_argument("--room", action="store_true", help="phase 11's run (l) instead")
    args = ap.parse_args()
    if args.room:
        room(args.seeds)
        return
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


def room(seeds: str) -> None:
    """Run (l)'s config on the room for each seed (module doc)."""
    from shine_mapping_tpu.cli import shine_incre
    from shine_mapping_tpu.config import SHINEConfig
    from shine_mapping_tpu_torch.eval.metrics import eval_mesh

    scores = []
    last = chip_smoke.ROOM_INCRE_EVERY * (chip_smoke.ROOM_INCRE_FRAMES - 1) + 1
    with tempfile.TemporaryDirectory(prefix="jax_room_") as tmp:
        kitti, gts, _ = chip_smoke.write_room(tmp)
        for seed in [int(s) for s in seeds.split(",")]:
            cfg, line = chip_smoke.surface_incre_config(SHINEConfig, kitti,
                                                        os.path.join(tmp, f"l{seed}"))
            cfg.seed = seed
            print(line + f"; seed {seed}", flush=True)
            t0 = time.perf_counter()
            run_path, _, _ = shine_incre.run_shine_mapping_incremental(cfg=cfg)
            m = eval_mesh(os.path.join(run_path, f"mesh/mesh_frame_{last}.ply"), gts["incre"],
                          **chip_smoke.ROOM_EVAL_KW)
            scores.append(round(m["F-score (%)"], 3))
            print(f"[jax incre] run (l), seed {seed}: F-score {m['F-score (%)']:.3f} %, "
                  f"precision {m['Precision [Accuracy] (%)']:.3f} %, recall "
                  f"{m['Recall [Completeness] (%)']:.3f} %, Chamfer-L1 "
                  f"{m['Chamfer_L1 (m)']:.5f} m; {time.perf_counter() - t0:.0f} s on the CPU",
                  flush=True)
    print(json.dumps({"l": {"F-score": scores, "mean": round(sum(scores) / len(scores), 3)}}))


if __name__ == "__main__":
    main()
