#!/usr/bin/env python3
"""Run one benchmark cell of the PyTorch port and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Sets the program up through the cell's driver (``drivers/<driver>.py``;
the batch driver writes the cell's scans from the seed under the temporary
directory), checks its first steps, trains for ``--seconds`` of whole units
(the batch driver's are chunks), with ``--trace 1`` runs a further stretch
with the program's spans on and one under the profiler, compares with the
plain reference and prints, as the last line of standard output, one
JSON object: ``correct``, ``attempted`` (steps in the window), ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and
``checked`` (each number compared beside its limit; also the last lines of
standard error).  Needs one CUDA card and exits non-zero without one.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

# one process on one CPU with one intra-op thread: the eager step is one
# host thread's dispatch, and runs spread less when it keeps its core
os.environ["OMP_NUM_THREADS"] = "1"
os.sched_setaffinity(0, {max(os.sched_getaffinity(0))})

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(1, os.path.dirname(HERE))
# keep libraries that can load JAX by themselves from doing so
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    import harness

    cell = harness.Cell(args.workload)
    need = int(cell.cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"{args.workload} needs {need} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                           t_start=T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"the run loaded {found}: the port must run without JAX", file=sys.stderr)
        return 3
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
