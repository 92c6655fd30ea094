"""Bring-up of the ranks and placement of the training state.

Port of ``shine_mapping_tpu/parallel/mesh.py``.  The JAX package's one
controller builds a 1-D ``Mesh`` and ``NamedSharding``s; here each rank is
a process of its own, and a :class:`DataGroup` (rank, world, card, process
group and a gloo side group for host data) takes the mesh's place:

* the batch: rank k trains samples ``[k bs / n, (k + 1) bs / n)`` of each
  global batch (``batch_sharded``'s split of the batch dim);
* ``table_sharding: replicated``: every rank holds the whole tables, the
  decoders' gradients are summed across ranks and every rank runs the same
  update on the gathered entries (:func:`place_training_state` checks that
  the ranks start from the same bits);
* ``table_sharding: rows``: rank k holds rows ``[k C_l / n, (k + 1) C_l /
  n)`` of every level's table and of its moments and shadow tables
  (``adam_kernel.shard_geometry``); the routed windows
  (``trainer.precompute_batch_windows(..., shards=n)``, placed by
  :func:`place_routed_windows`) bring each rank the rows its samples read
  and the gradients of its rows.

The ranks of a launch (:func:`launch_plan`): ``tpu.num_processes: P``
counts processes, as JAX's hosts, each running its local ranks (``mesh_shape
/ P``, or one a card it sees), so the world is every card of every process
as JAX's mesh is every device; one process of ``mesh_shape`` ranks; or
torchrun's one rank a process.  The backend is the caller's: NCCL where
each rank has a card of its own, gloo where ranks share a card or run on
the CPU.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import socket
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from . import comm


@dataclasses.dataclass
class DataGroup:
    """One rank's view of the data-parallel group: the default process
    group carries the tensors, ``host_group`` host data (gloo; None = the
    default group, when it is gloo); ``table_sharding`` is the layout
    :func:`place_training_state` placed the tables in."""

    rank: int
    world: int
    device: torch.device
    host_group: Any = None
    backend: str = "gloo"
    table_sharding: str = "replicated"

    @property
    def primary(self) -> bool:
        return self.rank == 0

    def batch_slice(self, n: int) -> slice:
        """This rank's share of a batch of ``n`` (a multiple of world)."""
        if n % self.world:
            raise ValueError(f"a batch of {n} does not split over {self.world} ranks")
        b = n // self.world
        return slice(self.rank * b, (self.rank + 1) * b)


def free_port() -> int:
    """A free TCP port on this host (for ``tcp://localhost:<port>``)."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


# How long a rank waits for the others, to join and in every collective
# after (init_process_group's timeout is the group's): ranks of processes
# that disagree on their counts fail after it rather than hang, and so does
# a rank left waiting in a collective while another does host work alone
# for longer (gloo's own default is 30 minutes, NCCL's 10)
JOIN_TIMEOUT = datetime.timedelta(minutes=10)


@dataclasses.dataclass(frozen=True)
class Launch:
    """Where this process's ranks come from: ``local`` ranks a process,
    ``processes`` processes, this one ``process_id``; global rank
    ``process_id x local + i`` for local rank i; all meet at
    ``init_method``."""

    process_id: int
    processes: int
    local: int
    init_method: str
    backend: str

    @property
    def world(self) -> int:
        return self.processes * self.local

    def rank(self, i: int) -> int:
        return self.process_id * self.local + i


def launch_plan(cfg, backend: Optional[str] = None) -> Optional[Launch]:
    """The ranks of a launch through the config's knobs (JAX
    ``setup_distributed``: ``tpu.num_processes`` counts processes, each
    driving all of its cards; the mesh spans every card of every process).

    * ``tpu.num_processes: P`` > 1: each process runs L local ranks, L =
      ``tpu.mesh_shape / P`` when ``mesh_shape`` > 1 (the global rank count,
      as JAX's device count), else the cards this process sees, else 1 on
      the CPU; they meet at ``tcp://{tpu.coordinator}``;
    * else torchrun's ``RANK`` / ``WORLD_SIZE`` (one rank a process): None,
      :func:`setup_distributed` joins them;
    * else ``tpu.mesh_shape: n`` > 1: one process of n ranks on a free
      localhost port;
    * else None (one rank).

    ``backend`` defaults to NCCL when every local rank has a card, else
    gloo.  Raises ValueError, before any group forms, for a config that
    cannot be met: no coordinator or process id, a ``mesh_shape`` that is
    not a multiple of P, NCCL asked for with fewer cards than local ranks."""
    n = int(getattr(cfg, "num_processes", 0) or 0)
    shape = int(getattr(cfg, "mesh_shape", 1) or 1)
    cuda = torch.device(cfg.device).type == "cuda"
    cards = torch.cuda.device_count() if cuda else 0
    if n > 1:
        pid = int(getattr(cfg, "process_id", -1))
        coord = getattr(cfg, "coordinator", "") or ""
        if not 0 <= pid < n or not coord:
            raise ValueError("tpu.num_processes > 1 needs tpu.process_id and "
                             f"tpu.coordinator (host:port), process_id in 0 .. {n - 1}")
        if shape > 1 and shape % n:
            raise ValueError(f"tpu.mesh_shape {shape} (the global rank count) is not a "
                             f"multiple of tpu.num_processes {n}")
        local = shape // n if shape > 1 else max(cards, 1)
        init = f"tcp://{coord}"
    elif int(os.environ.get("WORLD_SIZE", "1")) > 1:
        return None
    elif shape > 1:
        pid, n, local, init = 0, 1, shape, f"tcp://localhost:{free_port()}"
    else:
        return None
    if backend is None:
        backend = "nccl" if cuda and cards >= local else "gloo"
    if backend == "nccl" and cards < local:
        raise ValueError(f"NCCL takes one card a rank: {local} local ranks, {cards} "
                         "cards in this process")
    return Launch(pid, n, local, init, backend)


def setup_distributed(cfg, backend: Optional[str] = None, init_method: Optional[str] = None,
                      rank: Optional[int] = None, world: Optional[int] = None
                      ) -> Tuple[int, int]:
    """Join this process to the group and return (rank, world) (JAX
    ``setup_distributed``, parallel/mesh.py:32-86).

    Where the ranks come from: ``rank`` / ``world`` / ``init_method`` given
    (a spawned rank's, :class:`Launch`), else the config's knobs when they
    give this process one rank (:func:`launch_plan`; several local ranks
    are spawned by ``cli.common.spawn_ranks``, ValueError here), else
    torchrun's ``RANK`` / ``WORLD_SIZE`` (with ``MASTER_ADDR`` /
    ``MASTER_PORT``).  One process and no group: (0, 1), nothing
    initialised.  ``backend`` defaults to NCCL on the card and gloo on the
    CPU; a group already initialised (by the caller) is taken as it is.
    The group waits :data:`JOIN_TIMEOUT` for a rank, to join and in every
    collective."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    if world is None:
        plan = launch_plan(cfg, backend)
        if plan is not None:
            if plan.local > 1:
                raise ValueError(f"this launch runs {plan.local} ranks a process: spawn them "
                                 "(cli.common.spawn_ranks)")
            world, rank, init_method, backend = plan.world, plan.rank(0), plan.init_method, \
                plan.backend
        elif int(os.environ.get("WORLD_SIZE", "1")) > 1:
            world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
            init_method = "env://"
        else:
            return 0, 1
    if world <= 1:
        return 0, 1
    if backend is None:
        backend = "nccl" if torch.device(cfg.device).type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=init_method, rank=int(rank),
                            world_size=int(world), timeout=JOIN_TIMEOUT)
    return dist.get_rank(), dist.get_world_size()


def data_group(device) -> DataGroup:
    """The :class:`DataGroup` of this initialised process (one card per
    rank under NCCL: the rank's local card)."""
    rank, world = dist.get_rank(), dist.get_world_size()
    backend = dist.get_backend()
    host = None if backend == "gloo" else dist.new_group(backend="gloo")
    return DataGroup(rank=rank, world=world, device=torch.device(device), host_group=host,
                     backend=backend)


def rank_device(cfg, local_rank: int) -> torch.device:
    """The rank's card: ``cuda:local_rank`` when there are enough cards,
    else the one card the ranks share (gloo), or the CPU."""
    device = torch.device(cfg.device)
    if device.type != "cuda":
        return device
    n = torch.cuda.device_count()
    return torch.device("cuda", local_rank if local_rank < n else 0)


def checksum(tensors) -> torch.Tensor:
    """A (2,) int64 fingerprint of tensors' bits: the sum of their 32-bit
    words and of the words times their position (bit-equal tensors give
    equal fingerprints; a flipped bit changes both)."""
    a = torch.zeros((), dtype=torch.int64, device=tensors[0].device)
    b = torch.zeros_like(a)
    for t in tensors:
        w = t.detach().contiguous().reshape(-1)
        if w.element_size() == 2:
            w = w.view(torch.int16).to(torch.int64)
        else:
            w = w.view(torch.int32).to(torch.int64)
        a = a + w.sum()
        b = b + (w * (torch.arange(w.numel(), device=w.device) % 65521 + 1)).sum()
    return torch.stack([a, b])


def replicas_equal(grp: DataGroup, tensors) -> bool:
    """Do all ranks hold the same bits in ``tensors``?  (one gather of each
    rank's :func:`checksum`)"""
    sums = comm.all_gather(grp, checksum(list(tensors)))
    return bool((sums == sums[0]).all())


def state_tensors(params, opt_state):
    """The training state's tensors: tables, decoders and their moments."""
    from ..train.optimizer import FEATURES, dense_params

    ts = list(params[FEATURES]) + list(dense_params(params).values())
    for st in (opt_state.m, opt_state.v):
        for k, t in st.items():
            ts += list(t) if k == FEATURES else [t]
    return ts


def place_training_state(grp: DataGroup, params, opt_state, shadow: Optional[Dict] = None,
                         table_sharding: str = "replicated"):
    """The training state in the group's layout (JAX
    ``place_training_state``, parallel/mesh.py:148-199).  Every rank built
    the same state (same seed, same data); this checks it (one checksum
    gather; ValueError otherwise), then for ``rows`` keeps this rank's block
    of every level's table, of its moments and of the shadow tables (new
    tensors; the whole ones are dropped), for ``replicated`` keeps them
    whole.  Sets ``grp.table_sharding``.  Returns (params, opt_state,
    shadow)."""
    from ..ops.adam_kernel import shard_geometry, shard_row_base
    from ..train.optimizer import FEATURES, OptState

    if table_sharding not in ("replicated", "rows"):
        raise ValueError(f"table_sharding must be replicated or rows, not {table_sharding!r}")
    if not replicas_equal(grp, state_tensors(params, opt_state)):
        raise ValueError("the ranks built different training states: seed and data must "
                         "match on every rank")
    grp.table_sharding = table_sharding
    if table_sharding == "replicated" or grp.world == 1:
        return params, opt_state, shadow
    shapes = [tuple(f.shape) for f in params[FEATURES]]
    sizes, _ = shard_geometry(shapes, grp.world)
    base = shard_row_base(shapes, grp.world, grp.rank)

    def cut(ts):
        return [t[b:b + s].clone() for t, b, s in zip(ts, base, sizes)]

    params = dict(params, **{FEATURES: cut(params[FEATURES])})
    m, v = dict(opt_state.m), dict(opt_state.v)
    m[FEATURES], v[FEATURES] = cut(m[FEATURES]), cut(v[FEATURES])
    if shadow is not None:
        shadow = {k: cut(t) for k, t in shadow.items()}
    return params, OptState(m=m, v=v, step=opt_state.step), shadow


def place_routed_windows(grp: DataGroup, windows):
    """This rank's part of routed windows (JAX ``place_routed_windows``,
    parallel/mesh.py:111-145): its served rows, send selections, receive
    map and shard prep, the others' dropped, and the global entry prep
    dropped (the routed step never reads it).  The windows' sample indices
    stay whole (the step takes its slice and the loss's global counts from
    them).  Windows routed for this rank alone
    (``precompute_batch_windows(..., shards=n, rank=)``, what a training
    rank builds: 1/n of the routing's work and bytes) are already placed."""
    if windows.route is None:
        raise ValueError("place_routed_windows takes windows precomputed with shards=n")
    if windows.route.rank == grp.rank:
        return windows
    return dataclasses.replace(windows, route=windows.route.local_part(grp.rank))


def gather_table_rows(grp: DataGroup, blocks):
    """Each level's whole table from every rank's row block (one gather a
    level; every rank gets them): the checkpoint's and the mesher's view of
    row-sharded tables."""
    return [comm.all_gather(grp, b).reshape((-1,) + tuple(b.shape[1:])) for b in blocks]
