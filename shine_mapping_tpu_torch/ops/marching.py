"""Iso-surface extraction: vectorized marching tetrahedra.

The port's copy of ``shine_mapping_tpu/ops/marching.py`` (jax-free there
too).  Replaces ``skimage.measure.marching_cubes`` used by the reference
(utils/mesher.py:216).  Each grid cell is split into 6 tetrahedra; the 16
sign configurations per tetrahedron yield 0-2 triangles with vertices
linearly interpolated on the crossing edges.  The case table below is
derived from first principles (crossing-edge cycles per configuration), not
copied tables.  Triangle winding is normalized afterwards using the field
gradient, so normals consistently point toward positive SDF.

Masking matches the reference semantics (utils/mesher.py:80-89,200-222):
a cell participates only if all 8 of its corners are masked valid.

Two versions of one function: the C++ one (``csrc/marching.cpp``, built with
g++ at first use) and the plain vectorized numpy one,
:func:`marching_tetrahedra_plain`, which the tests hold it against and a
caller may ask for by name.  :func:`marching_tetrahedra` runs the C++ one
and raises when it cannot be built: it does not fall back.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

# cube corner offsets, bit order (x<<2 | y<<1 | z) matching ops/morton
_CUBE = np.array(
    [
        [0, 0, 0], [0, 0, 1], [0, 1, 0], [0, 1, 1],
        [1, 0, 0], [1, 0, 1], [1, 1, 0], [1, 1, 1],
    ],
    dtype=np.int64,
)

# 6-tetrahedra decomposition of the cube around the main diagonal 0-7
# (all tets share corners 0 and 7; consistent across neighboring cells)
_TETS = np.array(
    [
        [0, 4, 5, 7],
        [0, 5, 1, 7],
        [0, 1, 3, 7],
        [0, 3, 2, 7],
        [0, 2, 6, 7],
        [0, 6, 4, 7],
    ],
    dtype=np.int64,
)

# tetrahedron edges: pairs of local tet-vertex indices
_TET_EDGES = np.array(
    [[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]], dtype=np.int64
)

# case table: for each of 16 inside-bitmasks (bit i = tet vertex i inside),
# up to 2 triangles of tet-edge indices, -1 padded.
#
# Derivation: the crossing edges are exactly those connecting an inside to
# an outside vertex.  One inside vertex -> the 3 edges incident to it form a
# triangle.  Two inside vertices -> the 4 crossing edges form a quad whose
# cyclic order is fixed by shared endpoints; split into 2 triangles.
_CASES = -np.ones((16, 2, 3), dtype=np.int64)


def _edge_id(a: int, b: int) -> int:
    for i, (u, v) in enumerate(_TET_EDGES):
        if (u, v) == (min(a, b), max(a, b)):
            return i
    raise AssertionError


def _build_cases() -> None:
    for mask in range(1, 15):
        inside = [i for i in range(4) if mask >> i & 1]
        outside = [i for i in range(4) if not (mask >> i & 1)]
        if len(inside) == 1:
            i = inside[0]
            e = [_edge_id(i, o) for o in outside]
            _CASES[mask, 0] = e
        elif len(inside) == 3:
            o = outside[0]
            e = [_edge_id(o, i) for i in inside]
            _CASES[mask, 0] = e
        else:  # two inside: quad in cyclic order i0-o0, o0-i1, i1-o1, o1-i0
            i0, i1 = inside
            o0, o1 = outside
            e = [
                _edge_id(i0, o0),
                _edge_id(i1, o0),
                _edge_id(i1, o1),
                _edge_id(i0, o1),
            ]
            _CASES[mask, 0] = [e[0], e[1], e[2]]
            _CASES[mask, 1] = [e[0], e[2], e[3]]


_build_cases()


def marching_tetrahedra_native(
    sdf: np.ndarray,
    level: float = 0.0,
    mask: Optional[np.ndarray] = None,
    spacing: float = 1.0,
    origin: Optional[np.ndarray] = None,
):
    """The C++ version (csrc/marching.cpp), built at first use; raises when
    it cannot be built."""
    import ctypes

    from .native_build import load_library

    lib = load_library("marching")
    lib.mt_run.restype = ctypes.c_void_p
    sdf32 = np.ascontiguousarray(sdf, dtype=np.float32)
    X, Y, Z = sdf32.shape
    mask_ptr = None
    if mask is not None:
        mask8 = np.ascontiguousarray(mask, dtype=np.uint8)
        mask_ptr = mask8.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    origin_arr = np.zeros(3) if origin is None else np.asarray(origin, np.float64)
    origin_arr = np.ascontiguousarray(origin_arr)
    handle = lib.mt_run(
        sdf32.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        mask_ptr,
        ctypes.c_int64(X), ctypes.c_int64(Y), ctypes.c_int64(Z),
        ctypes.c_float(level), ctypes.c_double(spacing),
        origin_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    nv = ctypes.c_int64()
    nf = ctypes.c_int64()
    lib.mt_counts(ctypes.c_void_p(handle), ctypes.byref(nv), ctypes.byref(nf))
    verts = np.empty((nv.value, 3), np.float64)
    faces = np.empty((nf.value, 3), np.int64)
    lib.mt_copy(
        ctypes.c_void_p(handle),
        verts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        faces.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    lib.mt_free(ctypes.c_void_p(handle))
    return verts, faces


def marching_tetrahedra(
    sdf: np.ndarray,
    level: float = 0.0,
    mask: Optional[np.ndarray] = None,
    spacing: float = 1.0,
    origin: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Extract the ``level`` iso-surface of a dense 3D field with the C++
    version (:func:`marching_tetrahedra_native`; no fallback).

    Args:
        sdf: (X, Y, Z) field values (any float dtype).
        level: iso value.
        mask: optional (X, Y, Z) bool; a cell is processed only when all its
            8 corners are True (reference mc_mask semantics).
        spacing: voxel edge length (scalar) applied to the output vertices.
        origin: (3,) world offset added to the output vertices.

    Returns:
        vertices: (V, 3) float64, deduplicated on shared edges.
        triangles: (F, 3) int64, wound so normals point toward +field.
    """
    return marching_tetrahedra_native(sdf, level, mask, spacing, origin)


def marching_tetrahedra_plain(
    sdf: np.ndarray,
    level: float = 0.0,
    mask: Optional[np.ndarray] = None,
    spacing: float = 1.0,
    origin: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """The plain vectorized numpy version of :func:`marching_tetrahedra`
    (the same arguments and results)."""
    sdf = np.asarray(sdf, dtype=np.float64)
    X, Y, Z = sdf.shape
    if X < 2 or Y < 2 or Z < 2:
        return np.zeros((0, 3)), np.zeros((0, 3), dtype=np.int64)

    # flatten corner ids for dedup keys
    def gid(ix, iy, iz):
        return (ix * Y + iy) * Z + iz

    # cell bases
    cx, cy, cz = np.meshgrid(
        np.arange(X - 1), np.arange(Y - 1), np.arange(Z - 1), indexing="ij"
    )
    cx, cy, cz = cx.ravel(), cy.ravel(), cz.ravel()

    # corner values per cell: (C, 8)
    vals = np.empty((cx.size, 8), dtype=np.float64)
    ok = np.ones(cx.size, dtype=bool)
    if mask is not None:
        mask = np.asarray(mask, dtype=bool)
    for k in range(8):
        ox, oy, oz = _CUBE[k]
        vals[:, k] = sdf[cx + ox, cy + oy, cz + oz]
        if mask is not None:
            ok &= mask[cx + ox, cy + oy, cz + oz]

    inside8 = vals < level
    any_in = inside8.any(axis=1)
    all_in = inside8.all(axis=1)
    active = ok & any_in & ~all_in
    if not np.any(active):
        return np.zeros((0, 3)), np.zeros((0, 3), dtype=np.int64)

    cx, cy, cz, vals = cx[active], cy[active], cz[active], vals[active]
    A = cx.size

    # global corner ids per active cell (A, 8)
    gids = np.empty((A, 8), dtype=np.int64)
    for k in range(8):
        ox, oy, oz = _CUBE[k]
        gids[:, k] = gid(cx + ox, cy + oy, cz + oz)

    tri_edge_a = []  # per-triangle-vertex: global corner id a
    tri_edge_b = []
    for t in range(6):
        tv = _TETS[t]  # 4 cube-corner indices
        tvals = vals[:, tv]  # (A, 4)
        tmask = (
            (tvals[:, 0] < level).astype(np.int64)
            | ((tvals[:, 1] < level).astype(np.int64) << 1)
            | ((tvals[:, 2] < level).astype(np.int64) << 2)
            | ((tvals[:, 3] < level).astype(np.int64) << 3)
        )
        for tri in range(2):
            cases = _CASES[tmask, tri]  # (A, 3) tet-edge indices or -1
            emit = cases[:, 0] >= 0
            if not np.any(emit):
                continue
            ce = cases[emit]  # (E, 3)
            rows = np.nonzero(emit)[0]
            # map tet edges -> cube corner pairs -> global ids
            for corner in range(3):
                pair = _TET_EDGES[ce[:, corner]]  # (E, 2) local tet verts
                a = tv[pair[:, 0]]
                b = tv[pair[:, 1]]
                tri_edge_a.append(gids[rows, a])
                tri_edge_b.append(gids[rows, b])

    if not tri_edge_a:
        return np.zeros((0, 3)), np.zeros((0, 3), dtype=np.int64)

    # (T, 3) edge endpoints per triangle vertex
    ea = np.stack(
        [np.concatenate(tri_edge_a[i::3]) for i in range(3)], axis=1
    )
    eb = np.stack(
        [np.concatenate(tri_edge_b[i::3]) for i in range(3)], axis=1
    )

    # deduplicate edge-interpolated vertices
    lo = np.minimum(ea, eb)
    hi = np.maximum(ea, eb)
    ncorners = X * Y * Z
    keys = lo.astype(np.int64) * ncorners + hi
    uniq, inv = np.unique(keys, return_inverse=True)
    faces = inv.reshape(-1, 3)

    ulo = (uniq // ncorners).astype(np.int64)
    uhi = (uniq % ncorners).astype(np.int64)

    def unflat(g):
        iz = g % Z
        iy = (g // Z) % Y
        ix = g // (Z * Y)
        return np.stack([ix, iy, iz], axis=1).astype(np.float64)

    pa, pb = unflat(ulo), unflat(uhi)
    va = sdf.ravel()[ulo]
    vb = sdf.ravel()[uhi]
    denom = vb - va
    t = np.where(np.abs(denom) > 1e-12, (level - va) / np.where(denom == 0, 1, denom), 0.5)
    t = np.clip(t, 0.0, 1.0)
    verts = pa + t[:, None] * (pb - pa)

    # drop degenerate triangles (repeated vertices)
    good = (
        (faces[:, 0] != faces[:, 1])
        & (faces[:, 1] != faces[:, 2])
        & (faces[:, 0] != faces[:, 2])
    )
    faces = faces[good]

    # orient windings along the field gradient (normals toward +field)
    g = np.stack(np.gradient(sdf), axis=-1).reshape(-1, 3)
    vg = g[ulo] + t[:, None] * (g[uhi] - g[ulo])
    fn = np.cross(
        verts[faces[:, 1]] - verts[faces[:, 0]],
        verts[faces[:, 2]] - verts[faces[:, 0]],
    )
    fg = (vg[faces[:, 0]] + vg[faces[:, 1]] + vg[faces[:, 2]]) / 3.0
    flip = np.einsum("ij,ij->i", fn, fg) < 0
    faces[flip] = faces[flip][:, [0, 2, 1]]

    verts = verts * spacing
    if origin is not None:
        verts = verts + np.asarray(origin, dtype=np.float64)[None, :]
    return verts, faces


def vertex_normals(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Area-weighted average of face normals (o3d compute_vertex_normals).

    ``np.add.at`` is the fastest accumulator here — measured 1.6 s vs
    4.4 s for 9 bincounts at 4M faces on this host (numpy's ufunc.at
    fast path for contiguous int indexing)."""
    n = np.zeros_like(verts)
    fn = np.cross(
        verts[faces[:, 1]] - verts[faces[:, 0]],
        verts[faces[:, 2]] - verts[faces[:, 0]],
    )
    for k in range(3):
        np.add.at(n, faces[:, k], fn)
    norm = np.linalg.norm(n, axis=1, keepdims=True)
    return n / np.maximum(norm, 1e-12)
