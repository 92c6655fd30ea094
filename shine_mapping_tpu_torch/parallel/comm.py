"""The collectives of data-parallel and row-sharded training.

Each is a plain function on tensors over a :class:`~.mesh.DataGroup` and
returns the same bits on every rank: gathers and exchanges copy bytes, and
the sums gather every rank's part and add them in rank order (a ring
all-reduce would do as well on NCCL and gloo, but this holds by
construction, and what it sums is small: the decoders' gradients, the
loss aux, the touched rows of the lazy update).

* :func:`all_gather` — every rank's tensor stacked in rank order (the
  replicated kernel island's entries, the checksums);
* :func:`all_to_all` — equal blocks exchanged (the routed layout's served
  rows forward and entry gradients back);
* :func:`uneven_block` — every rank's cell counts and the block that holds
  the largest cell: an exchange with uneven counts (the live routing of
  iid steps on row-sharded tables) pads each cell to it and goes through
  :func:`all_to_all`;
* :func:`sum_across` — the rank-order sum of same-shaped tensors (the
  decoders' gradients, the loss aux);
* :func:`gather_bytes` — one byte string per rank over the gloo side group
  (host data: the sharded ingest's frame products, the run directory).

``COUNTS[op]`` holds ``[calls, bytes]``, the bytes being this rank's input;
``chip_smoke.py`` zeroes and reads them around a run, like
``adam_kernel.LAUNCHES``.

gloo takes CUDA tensors in every collective used here
(``scripts/probe_gloo_cuda.py``: native in torch 2.11 with CUDA 12.8), so
nothing is staged through host memory; an op that fails raises.  Uneven
exchanges go as equal blocks padded to the step's largest cell
(:func:`uneven_block`): one gather of the counts and one host read a step,
where padding every cell to its bound (``8 bs / n`` entries a level) would
move ~6 MiB a step at bs 8,192 over 2 ranks, mostly pads.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch
import torch.distributed as dist

COUNTS: Dict[str, List[int]] = {
    "all_gather": [0, 0], "all_to_all": [0, 0], "uneven_block": [0, 0], "sum_across": [0, 0],
    "gather_bytes": [0, 0],
}


def reset_counts() -> None:
    for v in COUNTS.values():
        v[0] = v[1] = 0


def _count(op: str, nbytes: int) -> None:
    COUNTS[op][0] += 1
    COUNTS[op][1] += int(nbytes)


def _gather(grp, t: torch.Tensor) -> torch.Tensor:
    # the ranks' tensors concatenated along dim 0 (what gloo takes), viewed
    # as stacked
    flat = t if t.dim() else t.reshape(1)
    out = torch.empty((grp.world * flat.shape[0],) + tuple(flat.shape[1:]), dtype=t.dtype,
                      device=t.device)
    dist.all_gather_into_tensor(out, flat)
    return out.reshape((grp.world,) + tuple(t.shape))


def all_gather(grp, t: torch.Tensor) -> torch.Tensor:
    """(world, *t.shape): rank k's ``t`` at [k].  Every rank passes a tensor
    of one shape and dtype."""
    t = t.contiguous()
    _count("all_gather", t.numel() * t.element_size())
    return _gather(grp, t)


def all_to_all(grp, t: torch.Tensor) -> torch.Tensor:
    """``t`` (world, ...): block [k] goes to rank k; returns (world, ...)
    with [k] the block rank k sent here."""
    t = t.contiguous()
    if t.shape[0] != grp.world:
        raise ValueError(f"all_to_all takes (world={grp.world}, ...), got {tuple(t.shape)}")
    _count("all_to_all", t.numel() * t.element_size())
    out = torch.empty_like(t)
    dist.all_to_all_single(out, t)
    return out


def uneven_block(grp, counts: torch.Tensor):
    """For an exchange whose cells hold uneven counts: ``counts`` (world,
    ...) int, the entries this rank sends each rank (and any finer cells).
    Returns (every rank's counts stacked, (world, world, ...): [s, d] what
    rank s sends rank d; the largest cell of any rank rounded up to
    a multiple of 8 (the shard prep's tile), at least 8, as a Python int).  Each rank then
    pads its cells to that block and exchanges them with
    :func:`all_to_all`; the receiver reads its real entries' counts from the
    stack.  One gather and one host read."""
    counts = counts.contiguous()
    _count("uneven_block", counts.numel() * counts.element_size())
    every = _gather(grp, counts)
    largest = int(every.max()) if every.numel() else 0
    return every, max(8, -(-largest // 8) * 8)


def sum_across(grp, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The sum over ranks of each tensor (same shapes on every rank), added
    in rank order in float32, from ONE gather."""
    if not tensors:
        return []
    flat = torch.cat([t.reshape(-1).to(torch.float32) for t in tensors])
    _count("sum_across", flat.numel() * flat.element_size())
    parts = _gather(grp, flat)
    total = parts[0].clone()
    for k in range(1, grp.world):
        total += parts[k]
    out, o = [], 0
    for t in tensors:
        out.append(total[o:o + t.numel()].reshape(t.shape).to(t.dtype))
        o += t.numel()
    return out


def gather_bytes(grp, data: bytes) -> List[bytes]:
    """Every rank's byte string, in rank order, over the gloo side group
    (two gathers: the lengths, then the strings padded to the longest)."""
    n = torch.tensor([len(data)], dtype=torch.int64)
    lens = [torch.zeros(1, dtype=torch.int64) for _ in range(grp.world)]
    dist.all_gather(lens, n, group=grp.host_group)
    longest = max(int(x) for x in lens)
    buf = torch.zeros(max(longest, 1), dtype=torch.uint8)
    if data:
        buf[: len(data)] = torch.frombuffer(bytearray(data), dtype=torch.uint8)
    outs = [torch.empty_like(buf) for _ in range(grp.world)]
    dist.all_gather(outs, buf, group=grp.host_group)
    _count("gather_bytes", len(data))
    return [bytes(o[: int(k)].numpy().tobytes()) for o, k in zip(outs, lens)]
