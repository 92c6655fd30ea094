#!/usr/bin/env python3
"""Which collectives of the gloo backend take CUDA tensors, in this torch.

    python3 scripts/probe_gloo_cuda.py [--ranks 2]

Spawns ``--ranks`` processes on card 0 (gloo allows several ranks on one
card, NCCL does not), joins them over ``tcp://localhost:<free port>`` and
tries each collective the port's ``parallel/comm.py`` uses on small CUDA
tensors.  Rank 0 prints one line per collective: ``native`` (the result is
right), or the error's first line.  ``parallel/comm.py`` stages the ops
that are not native through host memory when the group is gloo.
"""

from __future__ import annotations

import argparse
import socket

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _body(rank: int, world: int, port: int) -> None:
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world)
    dev = torch.device("cuda", 0)
    n = 4
    results = {}

    def attempt(name, fn):
        try:
            ok = fn()
            results[name] = "native" if ok else "wrong result"
        except Exception as e:  # noqa: BLE001 - the probe reports every refusal
            results[name] = f"refused: {type(e).__name__}: {str(e).splitlines()[0][:120]}"

    def all_reduce():
        t = torch.full((n,), float(rank + 1), device=dev)
        dist.all_reduce(t)
        return bool((t == world * (world + 1) / 2).all())

    def all_gather_into_tensor():
        out = torch.empty(world * n, device=dev)
        dist.all_gather_into_tensor(out, torch.full((n,), float(rank), device=dev))
        return bool((out.reshape(world, n)[:, 0] == torch.arange(world, device=dev)).all())

    def all_gather():
        outs = [torch.empty(n, device=dev) for _ in range(world)]
        dist.all_gather(outs, torch.full((n,), float(rank), device=dev))
        return all(bool((o == k).all()) for k, o in enumerate(outs))

    def all_to_all_single():
        inp = torch.arange(world * n, device=dev, dtype=torch.float32) + 100 * rank
        out = torch.empty_like(inp)
        dist.all_to_all_single(out, inp)
        want = torch.cat([torch.arange(rank * n, (rank + 1) * n, device=dev) + 100 * k
                          for k in range(world)]).float()
        return bool((out == want).all())

    def all_to_all_single_bf16():
        inp = (torch.arange(world * n, device=dev) + 100 * rank).to(torch.bfloat16)
        out = torch.empty_like(inp)
        dist.all_to_all_single(out, inp)
        want = torch.cat([torch.arange(rank * n, (rank + 1) * n, device=dev) + 100 * k
                          for k in range(world)]).to(torch.bfloat16)
        return bool((out == want).all())

    def broadcast():
        t = torch.full((n,), float(rank), device=dev)
        dist.broadcast(t, 0)
        return bool((t == 0).all())

    for name, fn in (("all_reduce", all_reduce),
                     ("all_gather_into_tensor", all_gather_into_tensor),
                     ("all_gather", all_gather), ("all_to_all_single", all_to_all_single),
                     ("all_to_all_single bf16", all_to_all_single_bf16),
                     ("broadcast", broadcast)):
        attempt(name, fn)
        dist.barrier()
    if rank == 0:
        print(f"torch {torch.__version__} cuda {torch.version.cuda}, gloo, {world} ranks "
              f"on {torch.cuda.get_device_name(0)}")
        for name, r in results.items():
            print(f"[gloo-cuda] {name}: {r}")
    dist.destroy_process_group()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=2)
    a = ap.parse_args()
    mp.start_processes(_body, args=(a.ranks, _free_port()), nprocs=a.ranks,
                       start_method="spawn", join=True)


if __name__ == "__main__":
    main()
