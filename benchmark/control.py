#!/usr/bin/env python3
"""The readings that the limits of ``correct`` are set from, on the card at
a cell's own size, one set-up a seed, all seeds in one process, through the
cell's driver (``drivers/<driver>.py``): its ``setup``, ``check`` and
``free``, then its ``control``, which gives each side's numbers: the
program against the plain reference (``program``, the lower readings), and
each control and planted fault in the program's place (the upper readings;
the batch driver's are the reference with TF32 products, with half of each
batch, and over a bfloat16 pool).

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 [--out FILE]

Prints one JSON line a seed and a summary: for each number the largest
program reading, and the smallest reading of each other side that gives it.
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
    drv = cell.driver
    if not hasattr(drv, "control"):
        raise SystemExit(f"{workload}: its driver has no control function")
    tmp = tempfile.mkdtemp(prefix="shine-control-")
    try:
        prog = drv.setup(cell, seed, device, tmp)
        checked = drv.check(prog)
        drv.free(prog)
        return {"seed": seed, **drv.control(prog, checked)}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def summary(rows: list) -> dict:
    out = {}
    for k in rows[0]["program"]:
        out[k] = {"program_max": max(r["program"][k] for r in rows)}
        for side in rows[0]:
            if side not in ("seed", "program") and k in rows[0][side]:
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
