"""Mesh reconstruction from the implicit map.

Port of ``shine_mapping_tpu/mesher.py`` (reference ``Mesher``,
utils/mesher.py:14-368): chunked no-grad SDF inference with the
marching-cubes visibility mask, dense bounding-box reconstruction,
octree-tiled reconstruction at a chosen query level, SDF-map export (sdf in
the intensity channel) and isolated-cluster filtering.

Inference runs on the grid's device.  JAX maps one jitted function over a
stack of chunks (``jax.lax.map``); here a Python loop runs fixed-size
chunks and writes each into output tensors allocated once on the device,
read back once.  Both grids (dense bbx and octree blocks) use the
node-lattice formulation: per block of points only the cells of a small
lattice are probed, their corner rows gathered once, and each point picks
its cell's 8 rows by an index gather from the block's lattice, which is
exact, so the result is bit-equal to the direct per-point path
(:func:`_infer_blocks` without lattice sizes, kept for the tests).  The
interpolation and the decoder sum in a fixed order, one rounded
elementwise operation at a time, so the card and the CPU give the same
field bit for bit.

Vertex semantics (``estimate_sem``): the ``sem`` decoder's argmax at every
vertex, queried on the device, coloured by ``labels_to_colors``, and the
free-space (class 0) vertices dropped (utils/mesher.py:224-238).  A
time-conditioned map is queried at the timestamp ``Mesher.ts``.  Not ported
yet (raises NotImplementedError naming its ROADMAP item): the data-parallel
``dp_mesh`` (Queue A item 14).
"""

from __future__ import annotations

import math
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .config import SHINEConfig
from .data import io
from .data.semantic_kitti import labels_to_colors
from .models.decoder import Decoder
from .ops.hashgrid import lookup_level_cells
from .ops.interp import corner_weights
from .ops.marching import marching_tetrahedra, vertex_normals
from .ops.morton import quantize_points
from .ops.query import interpolate_rows, query_feature_with_aux

# the one-hot operand of the JAX package's lattice selection is capped at
# 128 MB per chunk; the same cap sizes the port's chunks (the lattice's
# gathered rows grow with it), so both packages cut a grid alike
_LATTICE_CAP = 128 << 20


def _sync(device: torch.device) -> float:
    """Wall time after the device's queued work has run."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def _linear_in_order(x: torch.Tensor, lin: torch.nn.Linear) -> torch.Tensor:
    """``lin(x)`` summed over the inputs in order, one rounded elementwise
    multiply and add at a time: a matmul's summation order is the
    library's, and differs between the card and the CPU."""
    W = lin.weight
    acc = x[:, 0:1] * W[:, 0]
    for k in range(1, W.shape[1]):
        acc = acc + x[:, k:k + 1] * W[:, k]
    return acc if lin.bias is None else acc + lin.bias


def _hidden_in_order(dec: Decoder, feat: torch.Tensor) -> torch.Tensor:
    h = feat
    for lin in dec.layers:
        h = torch.relu(_linear_in_order(h, lin))
    return h


def _decode_sdf(geo: Decoder, feat: torch.Tensor, ts: Optional[float] = None) -> torch.Tensor:
    """``-geo.sdf(feat)`` (the sign flip of utils/mesher.py:72), or
    ``-geo.time_conditioned_sdf`` at the timestamp ``ts``, with every sum in
    a fixed order, so that a mesh is the same on every device."""
    if ts is not None:
        feat = torch.cat([feat, torch.full_like(feat[:, :1], float(ts))], dim=1)
    return -_linear_in_order(_hidden_in_order(geo, feat), geo.lout)[:, 0]


def _decode_sem(sem: Decoder, feat: torch.Tensor) -> torch.Tensor:
    """``sem.sem_label(feat)`` with every sum in a fixed order (int64)."""
    logits = _linear_in_order(_hidden_in_order(sem, feat), sem.nclass_out)
    return torch.argmax(torch.log_softmax(logits, dim=1), dim=1)


def _infer_core(geo: Decoder, features, tables, coords: torch.Tensor,
                levels: Tuple[int, ...], poly_on: bool, check_level: int,
                ts: Optional[float] = None, sem: Optional[Decoder] = None):
    """Direct per-point inference: (sdf, mask, sem labels or None) at
    ``coords`` (N, 3)."""
    feat, _, found = query_feature_with_aux(coords, tables, features, levels, poly_on)
    # mc mask: node found at the checked level (all 8 corners valid,
    # utils/mesher.py:80-89)
    return (_decode_sdf(geo, feat, ts), found[check_level],
            None if sem is None else _decode_sem(sem, feat))


def _lattice_core(features, tables, coord: torch.Tensor, origins_k: torch.Tensor,
                  npb: int, block: int, levels, n_list, poly_on: bool):
    """Interpolated features of ``coord`` (npb*block, 3), whose points lie in
    ``npb`` blocks, each inside a small lattice of cells per level anchored
    at its block origin's cell.

    Per level ``i`` the lattice is ``n_list[i]`` cells per axis starting at
    ``quantize(origins_k, level)``; callers guarantee that every point's cell
    falls inside it (node-aligned blocks: exact nesting; index-space blocks:
    n = floor(extent/cell) + 2).  The lattice cells are probed and their
    corner rows gathered once per block; each point takes its cell's rows by
    an index gather ``F[b, flat]``, exact by construction (the JAX package
    selects them with a one-hot matmul at HIGHEST precision).  Node
    assignment uses the same quantization as the direct path.  Returns
    (feat (npb*block, D), per level the found mask of each point)."""
    device = coord.device
    bidx = torch.arange(npb, device=device)[:, None]
    feat = None
    found_pts: List[torch.Tensor] = []
    for i, lvl in enumerate(levels):
        n = n_list[i]
        n3 = n ** 3
        q0 = quantize_points(origins_k, lvl).to(torch.int64)  # (npb, 3)
        lat = torch.arange(n3, device=device)
        lat_off = torch.stack([lat // (n * n), (lat // n) % n, lat % n], dim=1)
        corners, found_l = lookup_level_cells(tables[i], q0[:, None, :] + lat_off[None])
        # (npb, n3, 8, D), widened to f32 from bf16 tables: the rows, not the table
        F = features[i][corners.long()].float()
        qp = quantize_points(coord, lvl).to(torch.int64)
        a = qp.reshape(npb, block, 3) - q0[:, None, :]
        inrange = torch.all((a >= 0) & (a < n), dim=-1)
        flat = ((a[..., 0] * n + a[..., 1]) * n + a[..., 2]).clamp(0, n3 - 1)
        rows = F[bidx, flat]  # (npb, block, 8, D)
        found_p = found_l[bidx, flat] & inrange
        fi = interpolate_rows(corner_weights(coord, lvl, poly_on), found_p.reshape(-1),
                              rows.reshape(npb * block, 8, -1))
        feat = fi if feat is None else feat + fi
        found_pts.append(found_p.reshape(-1))
    return feat, found_pts


def _block_offsets(vb: int, npb: int, step: float, device):
    """For ``npb`` blocks of vb^3 points: each point's block index and its
    offset times ``step`` (an f32 value), rounded once, as JAX's
    ``off.astype(f32) * step``."""
    block = vb ** 3
    idx = torch.arange(npb * block, device=device)
    w = idx % block
    off = torch.stack([w // (vb * vb), (w % (vb * vb)) // vb, w % vb], dim=1)
    return idx // block, off.to(torch.float32) * step


@torch.no_grad()
def _infer_blocks(geo: Decoder, features, tables, origins: torch.Tensor, step: float,
                  vb: int, levels, poly_on: bool, check_level: int,
                  n_list: Optional[Sequence[int]] = None, npb: Optional[int] = None,
                  ts: Optional[float] = None):
    """SDF and mask of every point of the blocks whose origins ``origins``
    (B, 3) lists, vb^3 points a block at ``step`` apart, ``npb`` blocks a
    chunk (B a multiple of it): the node-lattice path with ``n_list``, else
    the direct per-point path; a time-conditioned decoder at ``ts``.
    Block-major outputs, (B * vb^3,) each, on the device."""
    device = origins.device
    block = vb ** 3
    B = origins.shape[0]
    npb = B if npb is None else npb
    node, offstep = _block_offsets(vb, npb, step, device)
    sdf = torch.empty(B * block, dtype=torch.float32, device=device)
    mask = torch.empty(B * block, dtype=torch.bool, device=device)
    for b0 in range(0, B, npb):
        origins_k = origins[b0:b0 + npb]
        # two rounded f32 operations, multiply (in offstep) then add: the
        # node assignment at block edges then matches the JAX package's
        coord = origins_k[node] + offstep
        if n_list is None:
            s, m, _ = _infer_core(geo, features, tables, coord, levels, poly_on,
                                  check_level, ts)
        else:
            feat, found = _lattice_core(features, tables, coord, origins_k, npb, block,
                                        levels, n_list, poly_on)
            s, m = _decode_sdf(geo, feat, ts), found[check_level]
        sdf[b0 * block:(b0 + npb) * block] = s
        mask[b0 * block:(b0 + npb) * block] = m
    return sdf, mask


def _grid_block_origins(origin_s: np.ndarray, step: float, vb: int, nbx: int, nby: int,
                        nbz: int, n_blocks: int, device) -> torch.Tensor:
    """Origins of the dense grid's index-space blocks, block-major
    (x slowest), padded to ``n_blocks``: ``origin_s + b * (vb * step)`` in
    f32, as the JAX package computes them."""
    bi = torch.arange(n_blocks, device=device)
    byz = torch.stack([bi // (nby * nbz), (bi % (nby * nbz)) // nbz, bi % nbz], dim=1)
    bstep = float(np.float32(vb) * np.float32(step))
    return torch.from_numpy(origin_s).to(device)[None, :] + byz.to(torch.float32) * bstep


class Mesher:
    def __init__(self, config: SHINEConfig, grid, geo_params: Decoder,
                 sem_params: Optional[Decoder] = None, dp_mesh=None):
        if dp_mesh is not None:
            raise NotImplementedError(
                "not ported yet, see ROADMAP.md: data-parallel meshing (dp_mesh, "
                "Queue A item 14)")
        self.config = config
        self.grid = grid  # HashGridHost
        self.geo_params = geo_params  # the geometry Decoder
        self.sem_params = sem_params
        self.world_scale = config.scale
        self.ts = 0  # the query timestamp of a time-conditioned map
        self.global_transform = np.eye(4)
        # seconds by stage of the last reconstruction: query, readback,
        # marching, finalize
        self.timing: Dict[str, float] = {}

    # ------------------------------------------------------------------ helpers
    @property
    def device(self) -> torch.device:
        return self.grid.features[0].device

    def _check_level(self) -> int:
        return min(self.grid.featured_level_num, self.config.mc_vis_level) - 1

    def _ts(self) -> Optional[float]:
        return float(np.float32(self.ts)) if self.config.time_conditioned else None

    def _sem(self, query_sem: bool) -> Optional[Decoder]:
        if query_sem and self.sem_params is None:
            raise ValueError("semantic queries need the sem decoder (sem_params)")
        return self.sem_params if query_sem else None

    def _args(self):
        return (self.geo_params, list(self.grid.features), list(self.grid.tables))

    # ------------------------------------------------------------------ queries
    @torch.no_grad()
    def query_points(self, coords: np.ndarray, bs: int, query_sdf: bool = True,
                     query_sem: bool = False, query_mask: bool = True):
        """Batched SDF / mask inference (utils/mesher.py:33-108) at ``coords``
        in the scaled [-1,1] system, ``bs`` points a chunk; numpy outputs
        (sdf float64, sem labels int64 or None, mask bool)."""
        geo, feats, tables = self._args()
        sem_dec = self._sem(query_sem)
        x = torch.from_numpy(np.ascontiguousarray(coords, dtype=np.float32)).to(self.device)
        n = x.shape[0]
        sdf = torch.empty(n, dtype=torch.float32, device=self.device)
        mask = torch.empty(n, dtype=torch.bool, device=self.device)
        sem = torch.empty(n, dtype=torch.int64, device=self.device)
        for a in range(0, n, bs):
            sdf[a:a + bs], mask[a:a + bs], lab = _infer_core(
                geo, feats, tables, x[a:a + bs], tuple(self.grid.levels),
                self.grid.polynomial_interpolation, self._check_level(), self._ts(), sem_dec)
            if lab is not None:
                sem[a:a + bs] = lab
        return (sdf.cpu().numpy().astype(np.float64) if query_sdf else None,
                sem.cpu().numpy() if query_sem else None,
                mask.cpu().numpy() if query_mask else None)

    @torch.no_grad()
    def query_grid(self, voxel_num_xyz, voxel_origin, voxel_size: float,
                   query_sdf: bool = True, query_sem: bool = False,
                   query_mask: bool = True):
        """Dense-grid inference with the coordinates made on the device from
        the flat index (``get_query_from_bbx`` + ``query_points`` without the
        host grid); flat outputs in grid order."""
        geo, feats, tables = self._args()
        sem_dec = self._sem(query_sem)
        n = int(np.prod(voxel_num_xyz))
        bs = self.config.infer_bs
        step = float(np.float32(voxel_size * self.world_scale))
        origin_s = torch.from_numpy(
            (np.asarray(voxel_origin, np.float64) * self.world_scale).astype(np.float32)
        ).to(self.device)
        ny, nz = int(voxel_num_xyz[1]), int(voxel_num_xyz[2])
        sdf = torch.empty(n, dtype=torch.float32, device=self.device)
        mask = torch.empty(n, dtype=torch.bool, device=self.device)
        sem = torch.empty(n, dtype=torch.int64, device=self.device)
        for a in range(0, n, bs):
            idx = torch.arange(a, min(a + bs, n), device=self.device)
            ijk = torch.stack([idx // (ny * nz), (idx % (ny * nz)) // nz, idx % nz], dim=1)
            coord = ijk.to(torch.float32) * step + origin_s[None, :]
            sdf[a:a + bs], mask[a:a + bs], lab = _infer_core(
                geo, feats, tables, coord, tuple(self.grid.levels),
                self.grid.polynomial_interpolation, self._check_level(), self._ts(), sem_dec)
            if lab is not None:
                sem[a:a + bs] = lab
        return (sdf.cpu().numpy().astype(np.float64) if query_sdf else None,
                sem.cpu().numpy() if query_sem else None,
                mask.cpu().numpy() if query_mask else None)

    @torch.no_grad()
    def query_grid_lattice(self, voxel_num_xyz, voxel_origin, voxel_size: float):
        """Dense-grid inference through index-space blocks of 8^3 voxels and
        their node lattices.  The grid is not node-aligned, so the lattice
        per level is floor(block extent / cell) + 2 cells a side.  Returns
        3D (nx, ny, nz) numpy arrays (sdf float32, None, mask bool)."""
        t0 = time.perf_counter()
        vb = 8
        step = voxel_size * self.world_scale  # float64, as JAX sizes the lattice
        n_list = tuple(int((vb - 1) * step / (2.0 ** (1 - lvl))) + 2
                       for lvl in self.grid.levels)
        block = vb ** 3
        lattice_cap = max(1, _LATTICE_CAP // (block * max(n_list) ** 3 * 4))
        npb = max(1, min(self.config.infer_bs // block, lattice_cap))
        nbx, nby, nbz = (-(int(v) // -vb) for v in voxel_num_xyz)
        NB = nbx * nby * nbz
        K = math.ceil(NB / npb)
        origin_s = (np.asarray(voxel_origin, np.float64) * self.world_scale).astype(np.float32)
        step32 = float(np.float32(step))
        origins = _grid_block_origins(origin_s, step32, vb, nbx, nby, nbz, K * npb,
                                      self.device)
        sdf, mask = _infer_blocks(*self._args(), origins, step32, vb,
                                  tuple(self.grid.levels), self.grid.polynomial_interpolation,
                                  self._check_level(), n_list, npb, self._ts())
        t1 = _sync(self.device)
        sdf, mask = sdf.cpu().numpy(), mask.cpu().numpy()
        self.timing = {"query": t1 - t0, "readback": time.perf_counter() - t1}
        nx, ny, nz = (int(v) for v in voxel_num_xyz)

        def assemble(x):  # block-major -> (nx, ny, nz)
            a = x[: NB * block].reshape(nbx, nby, nbz, vb, vb, vb)
            a = a.transpose(0, 3, 1, 4, 2, 5).reshape(nbx * vb, nby * vb, nbz * vb)
            return a[:nx, :ny, :nz]

        return assemble(sdf), None, assemble(mask)

    # ------------------------------------------------------------------ grids
    def grid_shape_from_bbx(self, bbx, voxel_size: float):
        """(voxel_num_xyz, voxel_origin) for a world-space bbx — the grid
        geometry of ``get_query_from_bbx`` without materializing coords."""
        min_bound, max_bound = np.asarray(bbx[0], float), np.asarray(bbx[1], float)
        len_xyz = max_bound - min_bound
        voxel_num_xyz = (
            np.ceil(len_xyz / voxel_size) + self.config.pad_voxel * 2
        ).astype(np.int64)
        voxel_origin = min_bound - self.config.pad_voxel * voxel_size
        # extra voxel underground for the ground surface (utils/mesher.py:128-130)
        voxel_origin[2] -= voxel_size
        voxel_num_xyz[2] += 1
        return voxel_num_xyz, voxel_origin

    def get_query_from_bbx(self, bbx, voxel_size: float):
        """Dense grid covering a world-space bbx (utils/mesher.py:110-150).

        bbx: (min_bound, max_bound) arrays in metres.
        """
        voxel_num_xyz, voxel_origin = self.grid_shape_from_bbx(bbx, voxel_size)
        x = np.arange(voxel_num_xyz[0])
        y = np.arange(voxel_num_xyz[1])
        z = np.arange(voxel_num_xyz[2])
        gx, gy, gz = np.meshgrid(x, y, z, indexing="ij")
        coord = np.stack([gx.ravel(), gy.ravel(), gz.ravel()], axis=1).astype(np.float64)
        coord = coord * voxel_size + voxel_origin[None, :]
        coord *= self.world_scale  # to [-1,1]
        return coord, voxel_num_xyz, voxel_origin

    def assign_to_bbx(self, sdf_pred, sem_pred, mc_mask, voxel_num_xyz):
        """Reshape flat query outputs to the 3D grid (utils/mesher.py:175-198)."""
        shape = tuple(int(v) for v in voxel_num_xyz)
        if sdf_pred is not None:
            sdf_pred = sdf_pred.reshape(shape)
        if sem_pred is not None:
            sem_pred = sem_pred.reshape(shape)
        if mc_mask is not None:
            mc_mask = mc_mask.reshape(shape).astype(bool)
        return sdf_pred, sem_pred, mc_mask

    # ------------------------------------------------------------------ mc
    def mc_mesh(self, mc_sdf, mc_mask, voxel_size: float, mc_origin):
        """Iso-surface extraction (utils/mesher.py:200-222), by the native
        marching tetrahedra (raises when it cannot be built)."""
        verts, faces = marching_tetrahedra(
            mc_sdf.astype(np.float64),
            level=0.0,
            mask=mc_mask if self.config.mc_mask_on else None,
            spacing=1.0,
        )
        verts = np.asarray(mc_origin)[None, :] + verts * voxel_size
        return verts, faces

    # ------------------------------------------------------------------ artifacts
    def generate_sdf_map(self, coord, sdf_pred, mc_mask, map_path: str):
        """Export the SDF as a point cloud with sdf in intensity
        (utils/mesher.py:152-173).  As in the JAX package, unobserved points
        (trashbin SDF) are dropped rather than tagged."""
        if mc_mask is not None:
            keep = np.asarray(mc_mask, bool)
            coord = coord[keep]
            sdf_pred = sdf_pred[keep]
        coord_world = coord / self.world_scale
        sdf_world = (
            sdf_pred
            * self.config.logistic_gaussian_ratio
            * self.config.sigma_sigmoid_m
        )
        pc = io.PointCloud(
            points=coord_world.astype(np.float64),
            intensity=sdf_world.astype(np.float64),
        )
        pc = pc.transform(self.global_transform)
        io.write_ply(map_path, pc)

    def filter_isolated_vertices(self, mesh: io.TriangleMesh, filter_cluster_min_tri: int = 300):
        """Drop small connected triangle clusters (utils/mesher.py:240-251)."""
        from scipy.sparse import coo_matrix
        from scipy.sparse.csgraph import connected_components

        nv = mesh.vertices.shape[0]
        if nv == 0 or mesh.triangles.shape[0] == 0:
            return mesh
        tri = mesh.triangles
        rows = np.concatenate([tri[:, 0], tri[:, 1], tri[:, 2]])
        cols = np.concatenate([tri[:, 1], tri[:, 2], tri[:, 0]])
        adj = coo_matrix((np.ones(rows.size), (rows, cols)), shape=(nv, nv))
        _, labels = connected_components(adj, directed=False)
        tri_label = labels[tri[:, 0]]
        # threshold by TRIANGLE count per cluster, like the reference's
        # cluster_n_triangles (utils/mesher.py:240-251)
        counts = np.bincount(tri_label, minlength=int(labels.max()) + 1)
        keep_tri = counts[tri_label] >= filter_cluster_min_tri
        mesh.triangles = tri[keep_tri]
        return mesh

    # ------------------------------------------------------------------ recon
    def recon_bbx_mesh(self, bbx, voxel_size: float, mesh_path: str, map_path: str,
                       save_map: bool = False, estimate_sem: bool = False,
                       estimate_normal: bool = True, filter_isolated_mesh: bool = True,
                       filter_free_space_vertices: bool = True) -> io.TriangleMesh:
        """Dense bounding-box reconstruction (utils/mesher.py:253-290)."""
        voxel_num_xyz, voxel_origin = self.grid_shape_from_bbx(bbx, voxel_size)
        mc_sdf, _, mc_mask3 = self.query_grid_lattice(voxel_num_xyz, voxel_origin, voxel_size)
        timing = dict(self.timing)
        if save_map:
            # grid coords derive from indices; flatten in grid order to
            # match the 3D query outputs (get_query_from_bbx layout)
            coord, _, _ = self.get_query_from_bbx(bbx, voxel_size)
            self.generate_sdf_map(coord, mc_sdf.reshape(-1).astype(np.float64),
                                  mc_mask3.reshape(-1), map_path)
        t0 = time.perf_counter()
        verts, faces = self.mc_mesh(mc_sdf, mc_mask3, voxel_size, voxel_origin)
        t1 = time.perf_counter()
        mesh = self._finalize_mesh(verts, faces, mesh_path, estimate_sem, estimate_normal,
                                   filter_isolated_mesh, filter_free_space_vertices)
        self.timing = {**timing, "marching": t1 - t0,
                       "finalize": time.perf_counter() - t1}
        return mesh

    @torch.no_grad()
    def recon_octree_mesh(self, query_level: int, mc_res_m: float, mesh_path: str,
                          map_path: str, save_map: bool = False, estimate_sem: bool = False,
                          estimate_normal: bool = True, filter_isolated_mesh: bool = True,
                          filter_free_space_vertices: bool = True) -> io.TriangleMesh:
        """Octree-tiled reconstruction at ``query_level``
        (utils/mesher.py:292-368): query per-node grid blocks through their
        node lattices, paste into a global grid, then one marching pass."""
        nodes = self.grid.get_octree_nodes(query_level)  # centers, [-1,1]
        if nodes.shape[0] == 0:
            return io.TriangleMesh(np.zeros((0, 3)), np.zeros((0, 3), np.int64))
        t0 = time.perf_counter()
        min_nodes = nodes.min(axis=0)
        max_nodes = nodes.max(axis=0)

        node_res = 2.0 ** (1 - query_level)  # node size in [-1,1]
        vox_per_node = int(np.ceil(node_res / self.world_scale / mc_res_m))
        mc_res_scaled = node_res / vox_per_node

        # round like the paste offsets below: float truncation can size the
        # grid one voxel short of the max node's block (e.g. extent/res =
        # 224.99999999999997 -> 224 while the offset rounds to 225)
        side = np.round((max_nodes - min_nodes) / mc_res_scaled).astype(int) + vox_per_node
        # float16 like the reference (utils/mesher.py:321-324): this dense
        # global grid is the peak host allocation of reconstruction
        grid_sdf = np.zeros(tuple(side), dtype=np.float16)
        grid_mask = np.zeros(tuple(side), dtype=bool)

        block = vox_per_node ** 3
        query_level = int(query_level)
        n_list = tuple(1 << max(0, lvl - query_level) for lvl in self.grid.levels)
        lattice_cap = max(1, _LATTICE_CAP // (block * max(n_list) ** 3 * 4))
        npb = max(1, min(self.config.infer_bs // block, lattice_cap))
        n_nodes = nodes.shape[0]
        K = math.ceil(n_nodes / npb)
        origins = (nodes - 0.5 * (node_res - mc_res_scaled)).astype(np.float32)
        # padded origins sit outside [-1,1]: their outputs are not pasted
        origins = np.concatenate(
            [origins, np.full((K * npb - n_nodes, 3), 3.0, np.float32)], axis=0)
        sdf_pred, mc_mask = _infer_blocks(
            *self._args(), torch.from_numpy(origins).to(self.device),
            float(np.float32(mc_res_scaled)), vox_per_node, tuple(self.grid.levels),
            self.grid.polynomial_interpolation, self._check_level(), n_list, npb, self._ts())
        t1 = _sync(self.device)
        sdf_pred = sdf_pred.cpu().numpy()
        mc_mask = mc_mask.cpu().numpy() if self.config.mc_mask_on else None
        t2 = time.perf_counter()
        box = (vox_per_node,) * 3
        for k in range(n_nodes):
            sdf3, _, mask3 = self.assign_to_bbx(
                sdf_pred[k * block:(k + 1) * block], None,
                None if mc_mask is None else mc_mask[k * block:(k + 1) * block], box)
            s = np.round((nodes[k] - min_nodes) / node_res * vox_per_node).astype(int)
            sl = tuple(slice(s[d], s[d] + vox_per_node) for d in range(3))
            grid_sdf[sl] = sdf3
            if mask3 is not None:
                grid_mask[sl] = mask3
        mc_voxel_size = mc_res_scaled / self.world_scale
        mc_origin = (min_nodes - 0.5 * (node_res - mc_res_scaled)) / self.world_scale
        verts, faces = self.mc_mesh(grid_sdf, grid_mask, mc_voxel_size, mc_origin)
        t3 = time.perf_counter()
        mesh = self._finalize_mesh(verts, faces, mesh_path, estimate_sem, estimate_normal,
                                   filter_isolated_mesh, filter_free_space_vertices)
        self.timing = {"query": t1 - t0, "readback": t2 - t1, "marching": t3 - t2,
                       "finalize": time.perf_counter() - t3}
        return mesh

    def estimate_vertices_sem(self, mesh: io.TriangleMesh, verts: np.ndarray,
                              filter_free_space_vertices: bool = True) -> io.TriangleMesh:
        """Vertex semantics and colours (utils/mesher.py:224-238): the sem
        decoder's class at each vertex (queried on the device); free-space
        (class 0) vertices dropped with ``filter_free_space_vertices``."""
        _, verts_sem, _ = self.query_points(verts * self.world_scale, self.config.infer_bs,
                                            False, True, False)
        mesh.vertex_colors = labels_to_colors(verts_sem)
        if filter_free_space_vertices:
            mesh = _remove_vertices(mesh, verts_sem > 0)
        return mesh

    def _finalize_mesh(self, verts, faces, mesh_path, estimate_sem, estimate_normal,
                       filter_isolated_mesh, filter_free_space_vertices) -> io.TriangleMesh:
        mesh = io.TriangleMesh(
            vertices=verts.astype(np.float64), triangles=faces.astype(np.int32)
        )
        if estimate_sem and self.sem_params is not None:
            mesh = self.estimate_vertices_sem(mesh, mesh.vertices, filter_free_space_vertices)
        if estimate_normal and mesh.vertices.shape[0] > 0:
            mesh.vertex_normals = vertex_normals(mesh.vertices, mesh.triangles)
        if filter_isolated_mesh:
            mesh = self.filter_isolated_vertices(mesh, self.config.min_cluster_vertices)
        mesh = mesh.transform(self.global_transform)
        if mesh_path:
            io.write_ply(mesh_path, mesh)
        return mesh


def _remove_vertices(mesh: io.TriangleMesh, keep: np.ndarray) -> io.TriangleMesh:
    """Drop vertices (and their triangles), compacting indices."""
    remap = -np.ones(mesh.vertices.shape[0], dtype=np.int64)
    remap[keep] = np.arange(int(keep.sum()))
    tri_keep = keep[mesh.triangles].all(axis=1)
    tri = remap[mesh.triangles[tri_keep]]
    return io.TriangleMesh(
        vertices=mesh.vertices[keep],
        triangles=tri.astype(np.int32),
        vertex_normals=None if mesh.vertex_normals is None else mesh.vertex_normals[keep],
        vertex_colors=None if mesh.vertex_colors is None else mesh.vertex_colors[keep],
    )
