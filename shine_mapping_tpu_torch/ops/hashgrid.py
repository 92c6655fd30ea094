"""Sparse hierarchical feature grid as device-resident spatial hash tables.

Port of ``shine_mapping_tpu/ops/hashgrid.py`` (the replacement of the
reference ``FeatureOctree``, model/feature_octree.py:29-298).  Per featured
level ``l`` (bottom-up, index 0 = finest = ``max_level``):

* ``keys : int32[S_l, 2]``        open-addressing hash slots holding a node's
  packed integer voxel coordinate as an interleaved (x<<16|y, z) pair
  (empty slots have keys[:, 1] == -1, the int32 view of 0xFFFFFFFF).
* ``corner_idx : int32[S_l, 8]``  feature-table rows of the node's 8 corners.
* ``features : f32[C_l, D]``      corner feature table; row ``C_l - 1`` is the
  reserved zero "trashbin" row that misses gather.

Structure growth (:meth:`HashGridHost.update`) is the JAX package's numpy
code unchanged, so the same seed and points give bit-identical hash tables,
corner rows and feature tables in both packages.  The device side holds
torch tensors; a growth step writes the touched slots and the new feature
rows in place with ``index_copy_``.

The continual-learning shadows (``importance_weight``,
``features_last_frame``) are tables of their own.  JAX's snapshot
``features_last_frame[l] = features[l]`` is a snapshot because jnp arrays
are immutable; the port trains ``features`` in place, so its snapshot is a
copy (``clone``), never an alias that would track the training.  Only an
incremental ``update`` takes one (the batch driver holds no snapshot).
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .morton import CORNER_OFFSETS, quantize_points, quantize_points_np

# number of consecutive slots probed on lookup; insertion guarantees every
# key lands inside its window (the table is rebuilt bigger otherwise)
PROBE = 16

# empty-slot sentinel for key_b (z coordinate never reaches 2**32-1)
EMPTY = np.uint32(0xFFFFFFFF)

_H1 = np.uint32(2654435761)
_H2 = np.uint32(805459861)
_H3 = np.uint32(3674653429)

_MASK32 = 0xFFFFFFFF


# --------------------------------------------------------------------------
# device-side structures


class LevelTable(NamedTuple):
    """Device tensors for one featured level's node hash table.

    ``keys`` interleaves the two packed key words per slot, bitcast to
    int32, so a probe gathers one contiguous 8-byte pair per slot."""

    keys: torch.Tensor  # int32[S, 2] — (key_a, key_b) bitcast
    corner_idx: torch.Tensor  # int32[S, 8]


def _hash_u32(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor,
              mask: int) -> torch.Tensor:
    """The JAX package's uint32 hash on int64 tensors.

    torch has no uint32 arithmetic to speak of, so each product is taken in
    int64 (x, y, z < 2**16 and H < 2**32, so it cannot overflow) and cut to
    its low 32 bits — exactly the uint32 wrap-around product."""
    hx = (x * int(_H1)) & _MASK32
    hy = (y * int(_H2)) & _MASK32
    hz = (z * int(_H3)) & _MASK32
    return (hx ^ hy ^ hz) & mask


def _interleave_keys(key_a: np.ndarray, key_b: np.ndarray,
                     device) -> torch.Tensor:
    """Host (key_a, key_b) uint32 words -> device int32[S, 2] pairs."""
    pairs = np.stack([key_a.view(np.int32), key_b.view(np.int32)], axis=1)
    return torch.from_numpy(pairs).to(device)


def _level_table(hl: "_HostLevel", device) -> LevelTable:
    return LevelTable(
        keys=_interleave_keys(hl.key_a, hl.key_b, device),
        corner_idx=torch.tensor(hl.corner_idx, device=device),  # a copy
    )


def lookup_level(
    table: LevelTable, coords: torch.Tensor, level: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Find the node containing each query point at ``level``.

    Args:
        table: the level's hash table tensors.
        coords: (N, 3) float points in the [-1, 1] cube.
        level: octree level.

    Returns:
        corners: (N, 8) int32 corner feature rows (a miss returns the rows of
            slot 0 of its probe window — callers mask by ``found``).
        found: (N,) bool, node present in the map.
    """
    return lookup_level_cells(table, quantize_points(coords, level))


def lookup_level_cells(
    table: LevelTable, q: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`lookup_level` on integer node cells ``q`` (..., 3): callers that
    derive the cells arithmetically (the mesher's node-lattice inference)
    skip the float quantization.  Keys and hashes keep the low 32 bits, as
    the JAX package's uint32 arithmetic does, so a cell past the grid's edge
    misses in both packages alike."""
    lead = q.shape[:-1]
    q = q.reshape(-1, 3).to(torch.int64)
    S = table.keys.shape[0]
    mask = S - 1
    x, y, z = q[:, 0], q[:, 1], q[:, 2]
    # x < 2**15 (level <= 15), so the packed word is a non-negative int32
    # and equals the int32 view of the JAX package's uint32 key
    qa = ((x << 16) | y).to(torch.int32)
    qb = z.to(torch.int32)
    h = _hash_u32(x, y, z, mask)
    # probe window of PROBE consecutive slots (wrapping)
    win = (h[:, None] + torch.arange(PROBE, device=q.device)[None, :]) & mask
    kk = table.keys[win]  # (N, PROBE, 2) — one contiguous gather
    hit = (kk[:, :, 0] == qa[:, None]) & (kk[:, :, 1] == qb[:, None])
    found = hit.any(dim=1)
    # first hit (argmax returns the first maximum, as jnp.argmax does)
    first = torch.argmax(hit.to(torch.uint8), dim=1)
    slot = torch.gather(win, 1, first[:, None])[:, 0]
    corners = table.corner_idx[slot]  # (N, 8)
    return corners.reshape(lead + (8,)), found.reshape(lead)


# --------------------------------------------------------------------------
# host-side growable structure (numpy, identical to the JAX package)


def _pack64(q: np.ndarray) -> np.ndarray:
    """(N,3) int coords -> unique int64 key (level <= 16)."""
    q = q.astype(np.int64)
    return (q[:, 0] << 32) | (q[:, 1] << 16) | q[:, 2]


def _unpack64(k: np.ndarray) -> np.ndarray:
    k = k.astype(np.int64)
    x = (k >> 32) & 0xFFFF
    y = (k >> 16) & 0xFFFF
    z = k & 0xFFFF
    return np.stack([x, y, z], axis=-1).astype(np.int32)


def _isin_sorted(values: np.ndarray, sorted_arr: np.ndarray) -> np.ndarray:
    """Membership of ``values`` in an ascending-sorted array."""
    if sorted_arr.size == 0:
        return np.zeros(values.shape, dtype=bool)
    pos = np.searchsorted(sorted_arr, values)
    pos = np.clip(pos, 0, sorted_arr.size - 1)
    return sorted_arr[pos] == values


@dataclasses.dataclass
class _HostLevel:
    """Host mirror + bookkeeping for one featured level."""

    level: int
    node_capacity: int
    corner_capacity: int  # feature rows incl. trashbin (last row)
    # hash-table mirrors
    key_a: np.ndarray = None  # uint32[S]
    key_b: np.ndarray = None  # uint32[S]
    corner_idx: np.ndarray = None  # int32[S, 8]
    # insertion-ordered node data (survives table rebuilds)
    node_coords: np.ndarray = None  # int32[n_nodes, 3]
    node_corner_rows: np.ndarray = None  # int32[n_nodes, 8]
    node_keys_sorted: np.ndarray = None  # int64[n_nodes] (ascending)
    # corner membership: ascending keys + their feature rows
    corner_keys_sorted: np.ndarray = None  # int64[n_corners]
    corner_rows_sorted: np.ndarray = None  # int32[n_corners]
    n_nodes: int = 0
    n_corners: int = 0

    def __post_init__(self):
        S = self.node_capacity
        self.key_a = np.zeros(S, dtype=np.uint32)
        self.key_b = np.full(S, EMPTY, dtype=np.uint32)
        self.corner_idx = np.full(
            (S, 8), self.corner_capacity - 1, dtype=np.int32
        )
        self.node_coords = np.zeros((0, 3), dtype=np.int32)
        self.node_corner_rows = np.zeros((0, 8), dtype=np.int32)
        self.node_keys_sorted = np.zeros(0, dtype=np.int64)
        self.corner_keys_sorted = np.zeros(0, dtype=np.int64)
        self.corner_rows_sorted = np.zeros(0, dtype=np.int32)

    # -- hash insertion ----------------------------------------------------
    def _try_insert_all(self, coords: np.ndarray, rows: np.ndarray) -> bool:
        """Insert nodes into the (cleared or existing) table mirror.

        Vectorized round-based probing: round ``p`` tries slot ``h + d_i``
        (each key's current displacement); winners per free slot are chosen
        with np.unique, losers advance their displacement.  Every key sits
        within PROBE slots of its hash — the only invariant the device
        lookup needs.  Records the written slots in ``last_insert_touched``.

        Returns False if any key's probe window overflowed (caller rebuilds
        with a larger table).
        """
        n = coords.shape[0]
        self.last_insert_touched = np.zeros(0, dtype=np.int32)
        if n == 0:
            return True
        touched_rounds = []
        S = self.node_capacity
        mask = np.uint32(S - 1)
        x = coords[:, 0].astype(np.uint32)
        y = coords[:, 1].astype(np.uint32)
        z = coords[:, 2].astype(np.uint32)
        ka = (x << np.uint32(16)) | y
        h = ((x * _H1) ^ (y * _H2) ^ (z * _H3)) & mask

        pending = np.arange(n)
        disp = np.zeros(n, dtype=np.uint32)
        # a key advances its displacement at most once per round; allow a few
        # extra rounds so slot contention inside one batch doesn't force a
        # premature rebuild
        for _round in range(4 * PROBE):
            if pending.size == 0:
                if touched_rounds:
                    self.last_insert_touched = np.concatenate(
                        touched_rounds).astype(np.int32)
                return True
            slots = (h[pending] + disp[pending]) & mask
            free = self.key_b[slots] == EMPTY
            # among pending keys targeting the same free slot, first wins
            cand = np.nonzero(free)[0]
            if cand.size:
                uniq_slots, first = np.unique(slots[cand], return_index=True)
                winners = pending[cand[first]]
                self.key_a[uniq_slots] = ka[winners]
                self.key_b[uniq_slots] = z[winners]
                self.corner_idx[uniq_slots] = rows[winners]
                touched_rounds.append(uniq_slots)
                placed = np.zeros(pending.size, dtype=bool)
                placed[cand[first]] = True
            else:
                placed = np.zeros(pending.size, dtype=bool)
            disp[pending[~placed]] += 1
            over = disp[pending[~placed]] >= PROBE
            if np.any(over):
                return False
            pending = pending[~placed]
        if pending.size == 0:
            if touched_rounds:
                self.last_insert_touched = np.concatenate(
                    touched_rounds).astype(np.int32)
            return True
        return False

    def _rebuild_table(self) -> None:
        """Re-hash every node into a (possibly larger) fresh table."""
        while True:
            S = self.node_capacity
            self.key_a = np.zeros(S, dtype=np.uint32)
            self.key_b = np.full(S, EMPTY, dtype=np.uint32)
            self.corner_idx = np.full((S, 8), self.corner_capacity - 1, dtype=np.int32)
            if self._try_insert_all(self.node_coords, self.node_corner_rows):
                return
            self.node_capacity *= 2


class HashGridHost:
    """Growable hierarchical feature grid (host controller).

    Owns numpy mirrors of the per-level hash tables plus the device feature
    tables (torch, on ``device``) and the continual-learning shadows
    (importance, last-frame snapshot).  ``update`` mirrors reference
    ``FeatureOctree.update``
    (model/feature_octree.py:114-166).  Initial features come from a numpy
    generator seeded with ``seed``, so both packages draw the same values.
    """

    def __init__(
        self,
        max_level: int,
        featured_level_num: int,
        feature_dim: int,
        feature_std: float,
        polynomial_interpolation: bool = True,
        leaf_vox_size: float = 0.5,
        seed: int = 42,
        init_node_capacity: int = 1 << 15,
        init_corner_capacity: int = 1 << 16,
        device="cuda",
    ):
        if featured_level_num < 1:
            raise ValueError("No level with grid features!")
        if max_level > 15:
            # corner coordinates reach 2**level; _pack64's 16-bit y/z
            # fields alias (x, y, 65536) with (x, y+1, 0) at level 16
            raise ValueError(
                f"max_level {max_level} > 15: corner keys would overflow "
                "the packed 16-bit coordinate fields"
            )
        self.max_level = max_level
        self.featured_level_num = featured_level_num
        self.free_level_num = max_level - featured_level_num + 1
        self.feature_dim = feature_dim
        self.feature_std = feature_std
        self.polynomial_interpolation = polynomial_interpolation
        self.leaf_vox_size = leaf_vox_size
        self.device = torch.device(device)
        # float32, or bfloat16 after cast_features (the bf16 map mode)
        self.feature_dtype = torch.float32
        self.rng = np.random.default_rng(seed)

        # bottom-up: index 0 = finest level (max_level)
        self.levels: Tuple[int, ...] = tuple(
            max_level - i for i in range(featured_level_num)
        )
        self.host_levels: List[_HostLevel] = [
            _HostLevel(
                level=l,
                node_capacity=init_node_capacity,
                corner_capacity=init_corner_capacity,
            )
            for l in self.levels
        ]
        self.tables: List[LevelTable] = [
            _level_table(hl, self.device) for hl in self.host_levels
        ]
        self.features: List[torch.Tensor] = [
            self._zeros(hl.corner_capacity) for hl in self.host_levels
        ]
        # continual-learning shadows (reference model/feature_octree.py:143-146)
        self.importance_weight: List[torch.Tensor] = [
            self._zeros(hl.corner_capacity) for hl in self.host_levels
        ]
        # None until an incremental update() takes the snapshot
        self.features_last_frame: List[Optional[torch.Tensor]] = [None] * featured_level_num

    def _zeros(self, rows: int, dtype=torch.float32) -> torch.Tensor:
        return torch.zeros((rows, self.feature_dim), dtype=dtype, device=self.device)

    # ---------------------------------------------------------------- properties
    @property
    def corner_counts(self) -> List[int]:
        return [hl.n_corners for hl in self.host_levels]

    def cast_features(self, dtype: torch.dtype) -> None:
        """Hold the feature tables in ``dtype`` (float32 or bfloat16) from now
        on: the bf16 map mode's tables, cast as the JAX batch driver casts
        them (shine_batch.py:245-248; to bf16 rounds to nearest even).
        Growth then writes its float32 initial rows rounded the same way.
        Replaces ``self.features``: take the trained parameters from it
        afterwards (``trainer.init_params``)."""
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"feature tables are float32 or bfloat16, not {dtype}")
        self.feature_dtype = dtype
        self.features = [f.to(dtype) for f in self.features]

    # ---------------------------------------------------------------- growth
    def update(self, surface_points: np.ndarray, incremental_on: bool = False) -> None:
        """Grow the structure from new surface points ([-1,1] cube coords).

        Mirrors reference ``FeatureOctree.update`` (model/feature_octree.py:
        114-166): for each featured level, find unseen nodes, allocate their
        unique corners with randn * feature_std init, and record the node ->
        corner-row mapping.  When ``incremental_on``, each level's last-frame
        snapshot becomes a copy of its grown table (importance rows of new
        corners start at zero), model/feature_octree.py:143-146,157-160.
        """
        # float32, matching the device-side query quantization exactly
        surface_points = np.asarray(surface_points, dtype=np.float32)
        for li, hl in enumerate(self.host_levels):
            q = quantize_points_np(surface_points, hl.level)
            node_keys = np.unique(_pack64(q))
            new_keys = node_keys[~_isin_sorted(node_keys, hl.node_keys_sorted)]
            if new_keys.size == 0:
                if incremental_on:
                    self._snapshot(li)
                continue
            new_nodes = _unpack64(new_keys)  # (M, 3)

            # unique corners of the new nodes
            corners = (
                new_nodes[:, None, :] + CORNER_OFFSETS[None, :, :]
            ).reshape(-1, 3)
            corner_keys = _pack64(corners)
            uniq_ck = np.unique(corner_keys)
            new_ck = uniq_ck[~_isin_sorted(uniq_ck, hl.corner_keys_sorted)]
            n_new_corners = new_ck.size

            # capacity management (features): trashbin occupies the last row
            need = hl.n_corners + n_new_corners
            grew_feat = False
            while need > hl.corner_capacity - 1:
                hl.corner_capacity *= 2
                grew_feat = True
            if grew_feat:
                self._grow_feature_tables(li)

            # rows for the new corners in ascending-key order (the
            # reference's torch.unique ordering, model/feature_octree.py:132-136)
            new_rows = np.arange(
                hl.n_corners, hl.n_corners + n_new_corners, dtype=np.int32
            )
            hl.n_corners += n_new_corners
            pos = np.searchsorted(hl.corner_keys_sorted, new_ck)
            hl.corner_keys_sorted = np.insert(hl.corner_keys_sorted, pos, new_ck)
            hl.corner_rows_sorted = np.insert(hl.corner_rows_sorted, pos, new_rows)

            # rows for all 8 corners of each new node
            pos = np.searchsorted(hl.corner_keys_sorted, corner_keys)
            rows8 = hl.corner_rows_sorted[pos].reshape(-1, 8).astype(np.int32)

            # record nodes (insertion order) and update membership
            hl.node_coords = np.concatenate([hl.node_coords, new_nodes], axis=0)
            hl.node_corner_rows = np.concatenate(
                [hl.node_corner_rows, rows8], axis=0
            )
            hl.node_keys_sorted = np.insert(
                hl.node_keys_sorted,
                np.searchsorted(hl.node_keys_sorted, new_keys),
                new_keys,
            )
            hl.n_nodes += new_keys.size

            # node hash-table insertion (grow + rebuild on pressure)
            rebuild = hl.n_nodes > hl.node_capacity // 2
            while hl.n_nodes > hl.node_capacity // 2:
                hl.node_capacity *= 2
            if not rebuild and not hl._try_insert_all(new_nodes, rows8):
                hl.node_capacity *= 2
                rebuild = True
            if rebuild:
                hl._rebuild_table()
                self.tables[li] = _level_table(hl, self.device)
            else:
                # write only the slots the insert touched, in place
                touched = hl.last_insert_touched
                t = self.tables[li]
                idx = torch.from_numpy(touched.astype(np.int64)).to(self.device)
                pairs = np.stack([hl.key_a[touched].view(np.int32),
                                  hl.key_b[touched].view(np.int32)], axis=1)
                t.keys.index_copy_(0, idx, torch.from_numpy(pairs).to(self.device))
                t.corner_idx.index_copy_(
                    0, idx, torch.from_numpy(hl.corner_idx[touched]).to(self.device))

            # new feature rows: randn * feature_std (reference
            # model/feature_octree.py:139,153).  n_new_corners can be 0 with
            # new NODES (a "hole" voxel whose corners all exist already)
            init = (
                self.feature_std
                * self.rng.standard_normal((n_new_corners, self.feature_dim))
            ).astype(np.float32)
            if n_new_corners:
                self.features[li].index_copy_(
                    0,
                    torch.from_numpy(new_rows.astype(np.int64)).to(self.device),
                    torch.from_numpy(init).to(self.device, self.feature_dtype),
                )
            if incremental_on:
                self._snapshot(li)

    def _snapshot(self, li: int) -> None:
        """The last-frame snapshot of level ``li``: a copy, since training
        writes ``features`` in place."""
        self.features_last_frame[li] = self.features[li].clone()

    def _grow_feature_tables(self, li: int) -> None:
        """Double a level's feature-table capacity (zero-padded)."""
        hl = self.host_levels[li]
        C = hl.corner_capacity

        def pad(a: torch.Tensor) -> torch.Tensor:
            out = self._zeros(C, a.dtype)
            out[: a.shape[0]] = a
            return out

        self.features[li] = pad(self.features[li])
        self.importance_weight[li] = pad(self.importance_weight[li])
        # _rebuild_table() reinitializes corner_idx with the NEW capacity's
        # trashbin row for empty slots
        hl._rebuild_table()
        self.tables[li] = _level_table(hl, self.device)

    # ---------------------------------------------------------------- host conveniences
    def get_octree_nodes(self, level: int) -> np.ndarray:
        """Node-center coordinates at ``level`` in the [-1,1] cube
        (reference ``FeatureOctree.get_octree_nodes``,
        model/feature_octree.py:94-101); the octree-tiled mesher's blocks."""
        li = self.levels.index(level)
        coords = self.host_levels[li].node_coords.astype(np.float64)
        node_size = 2.0 ** (1 - level)
        return coords * node_size - 1.0 + 0.5 * node_size

    def print_detail(self) -> str:
        """Per-level corner counts and map memory, coarse level first
        (model/feature_octree.py:288-298); printed and returned."""
        lines = ["Current map structure:"]
        total = 0
        for i in range(self.featured_level_num - 1, -1, -1):
            hl = self.host_levels[i]
            vox = self.leaf_vox_size * (2 ** (self.max_level - hl.level))
            cnt = hl.n_corners + 1  # + trashbin, matching the reference's count
            lines.append("%.2f m: %d voxel corners" % (vox, cnt))
            total += cnt
        mem = total * self.feature_dim * 4 / 1024 / 1024
        lines.append("memory: %d x %d x 4 = %.3f MB" % (total, self.feature_dim, mem))
        out = "\n".join(lines)
        print(out)
        return out

    # ---------------------------------------------------------------- (de)serialization
    def state_dict(self) -> dict:
        """Everything needed to restore the structure + features (numpy)."""
        d = {
            "max_level": self.max_level,
            "featured_level_num": self.featured_level_num,
            "feature_dim": self.feature_dim,
            "feature_std": self.feature_std,
            "poly": self.polynomial_interpolation,
            "leaf_vox_size": self.leaf_vox_size,
        }
        for i, hl in enumerate(self.host_levels):
            d[f"lvl{i}_node_coords"] = hl.node_coords
            d[f"lvl{i}_node_corner_rows"] = hl.node_corner_rows
            d[f"lvl{i}_n_corners"] = hl.n_corners
            # bf16 tables as their exact float32 upcast
            d[f"lvl{i}_features"] = self.features[i].detach().float().cpu().numpy()
            d[f"lvl{i}_importance"] = (
                self.importance_weight[i].detach().cpu().numpy())
        return d

    @classmethod
    def from_state_dict(cls, d: dict, seed: int = 42, device="cuda") -> "HashGridHost":
        """The grid that :meth:`state_dict` (of either package) describes, its
        tables and float32 features on ``device``.  The hash tables are
        rebuilt from the node lists, so their capacity may differ from the
        saved grid's; every lookup finds the same node and corner rows."""
        g = cls(
            max_level=int(d["max_level"]),
            featured_level_num=int(d["featured_level_num"]),
            feature_dim=int(d["feature_dim"]),
            feature_std=float(d["feature_std"]),
            polynomial_interpolation=bool(d["poly"]),
            leaf_vox_size=float(d["leaf_vox_size"]),
            seed=seed,
            device=device,
        )
        for i, hl in enumerate(g.host_levels):
            coords = np.asarray(d[f"lvl{i}_node_coords"])
            rows = np.asarray(d[f"lvl{i}_node_corner_rows"])
            feats = np.asarray(d[f"lvl{i}_features"], dtype=np.float32)
            hl.corner_capacity = feats.shape[0]
            hl.n_corners = int(d[f"lvl{i}_n_corners"])
            hl.n_nodes = coords.shape[0]
            hl.node_coords = coords.astype(np.int32)
            hl.node_corner_rows = rows.astype(np.int32)
            hl.node_keys_sorted = np.sort(_pack64(coords))
            # corner membership: every corner key of the nodes, its row
            all_corners = (coords[:, None, :] + CORNER_OFFSETS[None, :, :]).reshape(-1, 3)
            uk, first = np.unique(_pack64(all_corners), return_index=True)
            hl.corner_keys_sorted = uk
            hl.corner_rows_sorted = rows.reshape(-1)[first].astype(np.int32)
            while hl.n_nodes > hl.node_capacity // 2:
                hl.node_capacity *= 2
            hl._rebuild_table()
            g.tables[i] = _level_table(hl, g.device)
            g.features[i] = torch.from_numpy(feats.copy()).to(g.device)
            imp = d.get(f"lvl{i}_importance")
            g.importance_weight[i] = (g._zeros(feats.shape[0]) if imp is None else
                                      torch.from_numpy(np.asarray(imp, np.float32).copy())
                                      .to(g.device))
        return g
