"""The port's counterparts of the JAX round's kernel-study scripts.

One module per script of ``experiments/``, under the same file name, each
run by ``python -m shine_mapping_tpu_torch.experiments.<name>``:

* ``exp_fused_adam``      K3: the one-hot fused Adam over a (tb, w) sweep
* ``exp_pallas_debug``    K4: the bisection of its cost, six variants
* ``exp_pallas_trainer``  K5: the round-3 gather-hazard runs (``main2``)
* ``exp_narrow_blocks``   K6: the narrow-block elementwise sweep
* ``pallas_tile_rmw``     K7: the tile read-modify-write scatter-add

Each uses its script's bench shapes and prints its lines (to stderr, as the
scripts log), runs on ``cuda`` unless ``--device cpu`` is given, and times
the kernel with CUDA events on the card (the host clock on the CPU, where
the wrappers run their plain versions).  ``--small`` cuts the shapes for a
rehearsal on the CPU.  Nothing runs at import.
"""

from __future__ import annotations

import argparse
import sys
import time


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def parser(description: str) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--small", action="store_true",
                    help="cut the bench shapes for a rehearsal on the CPU")
    ap.add_argument("--iters", type=int, default=50, help="chained calls per timing")
    ap.add_argument("--reps", type=int, default=3, help="timings; the least is printed")
    return ap


def device_of(args):
    import torch

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run the plain versions")
    return dev


def describe(dev) -> str:
    import torch

    if dev.type == "cuda":
        return f"{torch.cuda.get_device_name(dev)} x{torch.cuda.device_count()}"
    return "cpu (the kernels' plain versions)"


def timed_ms(step, dev, iters: int = 50, reps: int = 3, warmup: int = 3) -> float:
    """Least mean time of ``step()`` over ``reps`` runs of ``iters`` chained
    calls: CUDA events on the card, the host clock on the CPU.  The warm-up
    calls let the caching allocator hold every buffer a chain of calls
    alternates between, so no device allocation falls in a timing."""
    import torch

    for _ in range(warmup):
        step()
    times = []
    for _ in range(reps):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                step()
            end.record()
            torch.cuda.synchronize(dev)
            times.append(start.elapsed_time(end) / iters)
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                step()
            times.append((time.perf_counter() - t0) / iters * 1e3)
    return min(times)
