#!/usr/bin/env python3
"""The readings that the limits of ``correct`` are set from, on the card at
a cell's own size, one set-up a seed, all seeds in one process:

* the program against the plain reference (the lower readings);
* the control: the reference computed with TF32 matrix products, one
  precision below the configuration's float32, in the program's place;
* a planted fault: the reference with half of each batch left out, the
  mean taken over the rest, in the program's place.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 [--out FILE]

Prints one JSON line a seed and a summary: for each number the largest
program reading, and the smallest reading of the control and of the fault.
"""

import argparse
import json
import os
import shutil
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(1, os.path.dirname(HERE))


def readings(workload: str, seed: int, device: str = "cuda", overrides=None) -> dict:
    import harness

    cell = harness.Cell(workload, overrides)
    batch = harness.load_module("drivers", "batch")
    tmp = tempfile.mkdtemp(prefix="shine-control-")
    try:
        prog = batch.Program(cell, seed, device, tmp)
        checked = batch.checked_steps(prog)
        prog.free()
        ref = batch.reference_readings(prog)
        out = {"seed": seed,
               "program": batch.gaps(checked, ref),
               "control_tf32": batch.gaps(batch.reference_readings(prog, tf32=True), ref),
               "fault_half_batch": batch.gaps(
                   batch.reference_readings(prog, half_batch=True), ref)}
        out["program"].update(batch.data_readings(prog))
        # the data stage's control: the pool's coordinates and labels held in
        # bfloat16, one precision below its float32
        pool = prog.dataset.pool
        kept = pool.coord, pool.sdf_label
        pool.coord, pool.sdf_label = (_bf16(a) for a in kept)
        out["control_bf16_pool"] = batch.data_readings(prog)
        pool.coord, pool.sdf_label = kept
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _bf16(a):
    import torch

    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


def summary(rows: list) -> dict:
    names = rows[0]["program"].keys()
    out = {}
    for k in names:
        out[k] = {"program_max": max(r["program"][k] for r in rows)}
        for side in ("control_tf32", "fault_half_batch", "control_bf16_pool"):
            if k in rows[0][side]:
                out[k][side + "_min"] = min(r[side][k] for r in rows)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("control.py needs a CUDA card", file=sys.stderr)
        return 2
    rows = []
    for s in (int(x) for x in args.seeds.split(",")):
        rows.append(readings(args.workload, s))
        print(json.dumps(rows[-1]), flush=True)
    summ = summary(rows)
    print(json.dumps({"workload": args.workload, "device": torch.cuda.get_device_name(0),
                      "seeds": len(rows), "summary": summ}))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"rows": rows, "summary": summ}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
