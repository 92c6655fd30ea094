"""A stand-in of the incremental CLI's frame loop (``cli.shine_incre``) for
the harness's dry run (``test_bench_runner.py``): a driver of an incremental
cell's shape, with no pool lookups and a unit of one whole frame, over a
point fit in plain PyTorch.

Each frame's scan (written by the traffic's generator) is voxelised into the
map (span ``data.octree``, the octree's growth) and becomes the frame's pool
(``data.pool``).  The frame then trains ``iters`` steps (span ``step``):
each draws ``bs`` pool points from the seed and moves the estimate by ``lr``
toward their mean, pulled toward the last frame's estimate by ``reg``
(span ``step.reg``, the continual-learning term).  Set-up processes the
first frame (timer ``data``; there is no ``precompute``), ``check`` runs its
first three steps, ``warm`` the rest; a unit is the next frame, ``None``
after the last; ``stretch(prog, n)`` runs ``n`` more steps of the current
frame.  ``control`` gives its own sides: the reference in float16 in the
program's place, and the reference with half of each batch.
"""

from __future__ import annotations

import os
import time

import numpy as np

from harness import _sync, load_module

CHECKED = 3


def _gen(device, seed: int, frame: int):
    import torch

    s = int(np.random.SeedSequence([seed, frame, 0x1DC]).generate_state(1, np.uint64)[0] >> 1)
    return torch.Generator(device).manual_seed(s)


class Program:
    def __init__(self, cell, seed: int, device: str, tmp: str):
        import torch

        self.seed, self.device, self.cfg, self.timers = seed, device, cell.config["config"], {}
        t = time.perf_counter()
        data = load_module("generators", cell.traffic["generator"]).generate(
            tmp, cell.traffic, seed, device)
        self.files = sorted(os.path.join(data["pc_path"], f) for f in os.listdir(data["pc_path"]))
        self.timers["scans"] = time.perf_counter() - t
        self.theta = torch.zeros(3, dtype=torch.float32, device=device)
        self.frame, self.voxels = -1, set()
        t = time.perf_counter()
        self.next_frame()
        _sync(device)
        self.timers["data"] = time.perf_counter() - t
        self.first_voxels = len(self.voxels)

    def next_frame(self) -> bool:
        import torch

        from plyio import read_ply_xyz
        from shine_mapping_tpu_torch.utils import profiling

        if self.frame + 1 == len(self.files):
            return False
        self.frame += 1
        pts = torch.from_numpy(read_ply_xyz(self.files[self.frame])).float().to(self.device)
        with profiling.span("data.octree"):
            keys = torch.unique(torch.floor(pts / self.cfg["leaf_m"]).long(), dim=0)
            self.voxels.update(map(tuple, keys.cpu().tolist()))
        with profiling.span("data.pool"):
            self.pool = pts
        self.last = self.theta.clone()
        self.gen = _gen(self.device, self.seed, self.frame)
        return True

    def steps(self, n: int) -> list:
        """``n`` steps on the current frame's pool; their losses."""
        import torch

        from shine_mapping_tpu_torch.utils import profiling

        c, losses = self.cfg, []
        for _ in range(n):
            with profiling.span("step"):
                idx = torch.randint(0, self.pool.shape[0], (c["bs"],), generator=self.gen,
                                    device=self.device)
                x = self.pool[idx]
                d = self.theta - self.last
                with profiling.span("step.reg"):
                    reg = 0.5 * c["reg"] * torch.sum(d * d)
                loss = 0.5 * torch.sum((self.theta - x) ** 2, 1).mean() + reg
                self.theta = self.theta - c["lr"] * (self.theta - x.mean(0) + c["reg"] * d)
                losses.append(float(loss))
        return losses


def reference(prog: Program, dtype=np.float64, half_batch: bool = False) -> dict:
    """The first frame again in NumPy at ``dtype``: its voxels and the losses
    of its first steps on the same draws."""
    import torch

    from plyio import read_ply_xyz

    c = prog.cfg
    pts = read_ply_xyz(prog.files[0])
    voxels = len(np.unique(np.floor(pts / c["leaf_m"]).astype(np.int64), axis=0))
    x_all, gen = pts.astype(dtype), _gen(prog.device, prog.seed, 0)
    theta = last = np.zeros(3, dtype)  # the first frame's last estimate is the start
    lr, reg, half, losses = dtype(c["lr"]), dtype(c["reg"]), dtype(0.5), []
    for _ in range(CHECKED):
        idx = torch.randint(0, len(pts), (c["bs"],), generator=gen, device=prog.device)
        x = x_all[idx.cpu().numpy()]
        if half_batch:
            x = x[: len(x) // 2]
        d = theta - last
        losses.append(float(half * np.mean(np.sum((theta - x) ** 2, 1))
                            + half * reg * np.sum(d * d)))
        theta = theta - lr * (theta - x.mean(0) + reg * d)
    return {"loss": losses, "voxels": voxels}


def gaps(prog: dict, ref: dict) -> dict:
    return {"loss_gap": max(abs(a - b) / abs(b) for a, b in zip(prog["loss"], ref["loss"])),
            "voxel_count_gap": abs(prog["voxels"] - ref["voxels"])}


# the driver's functions


setup = Program


def check(prog: Program) -> dict:
    return {"loss": prog.steps(CHECKED), "voxels": prog.first_voxels}


def warm(prog: Program) -> None:
    prog.steps(prog.cfg["iters"] - CHECKED)


def unit(prog: Program):
    """The next frame, processed and trained: (steps, batch samples)."""
    if not prog.next_frame():
        return None
    n = prog.cfg["iters"]
    prog.steps(n)
    return n, n * prog.cfg["bs"]


def stretch(prog: Program, n: int) -> None:
    prog.steps(n)


def work(prog: Program):
    return None


def free(prog: Program) -> None:
    prog.theta = prog.last = prog.pool = None


def compare(prog: Program, checked: dict) -> dict:
    return gaps(checked, reference(prog))


def control(prog: Program, checked: dict) -> dict:
    ref = reference(prog)
    return {"program": gaps(checked, ref),
            "control_f16": gaps(reference(prog, np.float16), ref),
            "fault_half_batch": gaps(reference(prog, half_batch=True), ref)}
