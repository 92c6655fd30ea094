#!/usr/bin/env python3
"""Which collectives of the gloo backend take CUDA tensors, in this torch.

    python3 scripts/probe_gloo_cuda.py [--ranks 2] [--backend gloo|nccl]

Spawns ``--ranks`` processes on card 0 (gloo allows several ranks on one
card; with ``--backend nccl`` one rank a card, which needs that many
cards), joins them over ``tcp://localhost:<free port>`` and tries each
collective the port's ``parallel/comm.py`` uses on small CUDA tensors, and
the two forms of an exchange with uneven counts: ``all_to_all_single`` with
uneven split sizes, and the counts gathered then every cell padded to the
largest for an equal-split ``all_to_all_single`` (``comm.uneven_block``).
Rank 0 prints one line per collective: ``native`` (the result is right),
or the error's first line.
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


def _body(rank: int, world: int, port: int, backend: str = "gloo") -> None:
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world)
    dev = torch.device("cuda", rank if backend == "nccl" else 0)
    torch.cuda.set_device(dev)
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

    def _uneven(k):  # rank k sends rank d (d + 1) * (k + 1) values of 100 k + d
        return [torch.full(((d + 1) * (k + 1),), float(100 * k + d), device=dev)
                for d in range(world)]

    def all_to_all_single_uneven():
        parts = _uneven(rank)
        out = torch.empty(sum((rank + 1) * (k + 1) for k in range(world)), device=dev)
        dist.all_to_all_single(out, torch.cat(parts),
                               output_split_sizes=[(rank + 1) * (k + 1) for k in range(world)],
                               input_split_sizes=[p.numel() for p in parts])
        want = torch.cat([_uneven(k)[rank] for k in range(world)])
        return bool((out == want).all())

    def uneven_padded():
        parts = _uneven(rank)
        counts = torch.tensor([p.numel() for p in parts], device=dev)
        every = torch.empty(world * world, dtype=counts.dtype, device=dev)
        dist.all_gather_into_tensor(every, counts)
        E = int(every.max())  # the one host read
        buf = torch.full((world, E), float("nan"), device=dev)
        for d, p in enumerate(parts):
            buf[d, :p.numel()] = p
        out = torch.empty_like(buf)
        dist.all_to_all_single(out, buf)
        n_in = every.reshape(world, world)[:, rank]
        got = torch.cat([out[k, :int(n_in[k])] for k in range(world)])
        want = torch.cat([_uneven(k)[rank] for k in range(world)])
        return bool((got == want).all())

    def broadcast():
        t = torch.full((n,), float(rank), device=dev)
        dist.broadcast(t, 0)
        return bool((t == 0).all())

    for name, fn in (("all_reduce", all_reduce),
                     ("all_gather_into_tensor", all_gather_into_tensor),
                     ("all_gather", all_gather), ("all_to_all_single", all_to_all_single),
                     ("all_to_all_single bf16", all_to_all_single_bf16),
                     ("all_to_all_single uneven splits", all_to_all_single_uneven),
                     ("counts gathered, cells padded to the largest, all_to_all_single",
                      uneven_padded),
                     ("broadcast", broadcast)):
        attempt(name, fn)
        dist.barrier()
    if rank == 0:
        print(f"torch {torch.__version__} cuda {torch.version.cuda}, {backend}, {world} ranks "
              f"on {torch.cuda.get_device_name(0)}")
        for name, r in results.items():
            print(f"[{backend}-cuda] {name}: {r}")
    dist.destroy_process_group()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--backend", default="gloo", choices=("gloo", "nccl"))
    a = ap.parse_args()
    mp.start_processes(_body, args=(a.ranks, _free_port(), a.backend), nprocs=a.ranks,
                       start_method="spawn", join=True)


if __name__ == "__main__":
    main()
