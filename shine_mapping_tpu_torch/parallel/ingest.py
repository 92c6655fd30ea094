"""Sharded data ingest over the ranks.

Port of ``shine_mapping_tpu/parallel/ingest.py``.  The data phase (scan
I/O, crop, downsample, normals, outlier removal, ray sampling:
``LiDARDataset.load_and_sample``) is host compute and the largest start-up
cost on long sequences.  It is split round robin: in round ``r`` rank ``p``
computes frame ``frame_ids[r * world + p]``, the frames' products are
exchanged over the group's gloo side group (``comm.gather_bytes``: each
product packed in ``_SCHEMA``'s fixed layout, a header of row counts, then
the rows' bytes), and EVERY rank integrates ALL frames in frame order.

``load_and_sample`` seeds its rng per frame (``(cfg.seed, frame_id)``,
data/dataset.py:221), so the integrated pool and octree are bit-identical
to a one-process data phase whichever rank computed which frame.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from ..data.io import PointCloud
from . import comm

# fixed exchange schema: (name, trailing columns, dtype)
_SCHEMA = (
    ("origin", 3, np.float64),
    ("points_s", 3, np.float64),
    ("fd_points", 3, np.float64),
    ("fd_normals", 3, np.float64),
    ("fd_intensity", 1, np.float64),
    ("coord", 3, np.float64),
    ("sdf_label", 1, np.float64),
    ("normal_label", 3, np.float64),
    ("sem_label", 1, np.int64),
    ("weight", 1, np.float64),
    ("sample_depth", 1, np.float64),
    ("ray_depth", 1, np.float64),
)


def _pack_prep(prep: Optional[dict]) -> List[Optional[np.ndarray]]:
    """Frame product dict -> ordered list matching _SCHEMA (None = absent)."""
    if prep is None:
        return [None] * len(_SCHEMA)
    fd = prep["frame_down"]
    coord, sdf, normal, sem, weight, sdepth, rdepth = prep["sampled"]
    return [
        np.asarray(prep["origin"], np.float64).reshape(1, 3),
        np.asarray(prep["points_s"], np.float64).reshape(-1, 3),
        np.asarray(fd.points, np.float64).reshape(-1, 3),
        None if fd.normals is None else np.asarray(fd.normals, np.float64),
        None if fd.intensity is None else np.asarray(fd.intensity, np.float64).reshape(-1, 1),
        np.asarray(coord, np.float64).reshape(-1, 3),
        np.asarray(sdf, np.float64).reshape(-1, 1),
        None if normal is None else np.asarray(normal, np.float64),
        None if sem is None else np.asarray(sem, np.int64).reshape(-1, 1),
        np.asarray(weight, np.float64).reshape(-1, 1),
        np.asarray(sdepth, np.float64).reshape(-1, 1),
        np.asarray(rdepth, np.float64).reshape(-1, 1),
    ]


def _unpack_prep(arrs: Sequence[Optional[np.ndarray]], frame_id: int) -> dict:
    """Inverse of _pack_prep."""
    (origin, points_s, fd_points, fd_normals, fd_intensity, coord, sdf,
     normal, sem, weight, sdepth, rdepth) = arrs
    frame_down = PointCloud(points=fd_points, normals=fd_normals,
                            intensity=None if fd_intensity is None else fd_intensity[:, 0])
    return {
        "frame_id": frame_id,
        "origin": origin[0],
        "points_s": points_s,
        "frame_down": frame_down,
        "sampled": (coord, sdf[:, 0], normal, None if sem is None else sem[:, 0],
                    weight[:, 0], sdepth[:, 0], rdepth[:, 0]),
    }


def _to_bytes(arrs: Sequence[Optional[np.ndarray]]) -> bytes:
    """One frame's products in the schema's layout: int64 row counts (-1 =
    absent), then each present field's rows, row-major, in schema order."""
    head = np.array([-1 if a is None else a.shape[0] for a in arrs], np.int64)
    body = [np.ascontiguousarray(a.reshape(-1, cols), dtype=dtype).tobytes()
            for a, (_, cols, dtype) in zip(arrs, _SCHEMA) if a is not None]
    return head.tobytes() + b"".join(body)


def _from_bytes(data: bytes) -> List[Optional[np.ndarray]]:
    head = np.frombuffer(data, np.int64, count=len(_SCHEMA))
    off = head.nbytes
    out: List[Optional[np.ndarray]] = []
    for n, (_, cols, dtype) in zip(head, _SCHEMA):
        if n < 0:
            out.append(None)
            continue
        size = int(n) * cols * np.dtype(dtype).itemsize
        out.append(np.frombuffer(data, dtype, count=int(n) * cols, offset=off)
                   .reshape(int(n), cols).copy())
        off += size
    return out


def process_frames_sharded(dataset, frame_ids: Sequence[int], group,
                           incremental_on: bool = False) -> int:
    """Sharded data phase (JAX ``process_frames_multihost``): each rank
    preprocesses every ``world``-th frame, the products are gathered, every
    rank integrates every frame in frame order.  Returns the number of new
    samples (the same on every rank)."""
    total = 0
    world, rank = group.world, group.rank
    frame_ids = list(frame_ids)
    for r0 in range(0, len(frame_ids), world):
        round_ids = frame_ids[r0:r0 + world]
        prep = dataset.load_and_sample(round_ids[rank]) if rank < len(round_ids) else None
        gathered = comm.gather_bytes(group, _to_bytes(_pack_prep(prep)))
        for i, fid in enumerate(round_ids):
            total += dataset._integrate_frame(_unpack_prep(_from_bytes(gathered[i]), fid),
                                              incremental_on)
    return total
