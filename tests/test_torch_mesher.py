"""The port's mesher (shine_mapping_tpu_torch/mesher.py) against the JAX
package's on the sphere setup of tests/test_mesher.py.

A sphere map trained by the port crosses over to the JAX package with
``HashGridHost.from_state_dict`` and ``interop.params_to_jax``; the port
runs on CPU tensors (its plain path: there is no kernel in the mesher).
Tolerances: masks and face arrays equal, sdf
``allclose(rtol=1e-5, atol=1e-6)``, vertices ``atol=1e-6``; the port's
lattice path bit-equal to its direct path.

XLA on the CPU contracts a block coordinate's ``origin + off * step`` into
one fused multiply-add where the port rounds the product and the sum (as it
must, for the card and the CPU to agree), so on a general grid ~10% of the
coordinates differ by an ulp and the sdf by ~1e-5 of its scale.  The mesh
comparisons therefore run on grids whose coordinates f32 holds exactly
(steps of 1/64), where both roundings agree.  There the sdf still differs by a few ulp (up
to 4.8e-7 at |sdf| 2.4: the MLP's sums run in another order), and a
vertex on an edge whose sdf changes by only ~1e-3 moves by that over the
change, a few 1e-6 of a unit: vertices are held to atol 1e-6 on 99.9% of
coordinates and 1e-5 on all."""

import numpy as np
import pytest
import torch

import jax

from shine_mapping_tpu.config import SHINEConfig as JaxConfig
from shine_mapping_tpu.data import io as jio
from shine_mapping_tpu.mesher import Mesher as JaxMesher
from shine_mapping_tpu.mesher import _remove_vertices as jax_remove_vertices
from shine_mapping_tpu.ops.hashgrid import HashGridHost as JaxGrid
from shine_mapping_tpu.ops.hashgrid import lookup_level_cells as jax_lookup_cells
from shine_mapping_tpu_torch.config import SHINEConfig
from shine_mapping_tpu_torch.data import io
from shine_mapping_tpu_torch.mesher import Mesher, _infer_blocks, _remove_vertices
from shine_mapping_tpu_torch.ops.hashgrid import HashGridHost, lookup_level_cells


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs files in parallel processes, and
    torch's thread pools in each would contend for the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(cls):
    cfg = cls()
    cfg.tree_level_world = 6
    cfg.tree_level_feat = 3
    cfg.leaf_vox_size = 0.5
    cfg.bs = 1024
    cfg.mc_vis_level = 1
    cfg.derive()
    cfg.scale = 1.0  # identity world scale, as tests/test_mesher.py
    cfg.infer_bs = 4096
    cfg.min_cluster_vertices = 20
    return cfg


@pytest.fixture(scope="module")
def setup():
    """A sphere of radius 0.5 mapped and trained by the port (150 steps on
    the CPU: a field with a real zero crossing, whose vertices do not hang
    on rounding noise), carried over to the JAX package."""
    from shine_mapping_tpu_torch.data.dataset import SamplePool
    from shine_mapping_tpu_torch.interop import params_to_jax
    from shine_mapping_tpu_torch.train import trainer
    from shine_mapping_tpu_torch.train.optimizer import init_opt_state

    jcfg, cfg = _cfg(JaxConfig), _cfg(SHINEConfig)
    rng = np.random.default_rng(0)
    dirs = rng.standard_normal((4000, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    surf = (dirs * 0.5).astype(np.float32)
    grid = HashGridHost(max_level=6, featured_level_num=3, feature_dim=cfg.feature_dim,
                        feature_std=cfg.feature_std, seed=0, init_node_capacity=1 << 12,
                        init_corner_capacity=1 << 12, device="cpu")
    grid.update(surf)
    disp = rng.uniform(-0.04, 0.04, (4000, 1))
    free = dirs * rng.uniform(0.3, 0.45, (4000, 1))
    pool = SamplePool(
        coord=np.concatenate([dirs * (0.5 + disp), free]).astype(np.float32),
        sdf_label=np.concatenate([disp[:, 0], np.linalg.norm(free, axis=1) - 0.5]).astype(np.float32),
        weight=np.concatenate([np.ones(4000), -np.ones(4000)]).astype(np.float32))
    cfg.lr = 0.01
    s = trainer.TrainSettings.from_config(cfg, grid.levels, sigma_sigmoid=0.05)
    params = trainer.init_params(cfg, grid, torch.Generator().manual_seed(0))
    dev, n = trainer.pool_to_device(pool, len(pool), device="cpu")
    trainer.train_chunk(params, init_opt_state(params), grid.tables, dev, n, 0,
                        torch.Generator().manual_seed(1), s, 150)
    geo = params_to_jax(params)["geo"]
    jgrid = JaxGrid.from_state_dict(grid.state_dict())
    return (JaxMesher(jcfg, jgrid, geo), Mesher(cfg, grid, params["geo"]), surf)


def _assert_vertices_close(got, want):
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert np.mean(np.abs(got - want) <= 1e-6) >= 0.999


def test_lookup_level_cells_matches_jax(setup):
    _, m, surf = setup
    # the JAX package's grid grown from the same points: the same hash
    # tables slot for slot, so misses land on the same rows too
    jgrid = JaxGrid(max_level=6, featured_level_num=3, feature_dim=8, feature_std=0.05,
                    seed=0, init_node_capacity=1 << 12, init_corner_capacity=1 << 12)
    jgrid.update(surf)
    rng = np.random.default_rng(1)
    for i, lvl in enumerate(m.grid.levels):
        nodes = m.grid.host_levels[i].node_coords
        cells = np.concatenate([nodes[rng.choice(len(nodes), 300)],
                                rng.integers(0, 2 ** lvl + 3, (300, 3))]).astype(np.int64)
        c, f = lookup_level_cells(m.grid.tables[i], torch.from_numpy(cells).reshape(20, 30, 3))
        jc, jf = jax_lookup_cells(jgrid.tables[i], jax.numpy.asarray(cells.astype(np.uint32)))
        np.testing.assert_array_equal(f.reshape(-1).numpy(), np.asarray(jf))
        np.testing.assert_array_equal(c.reshape(-1, 8).numpy(), np.asarray(jc))
        assert f.reshape(-1)[:300].all()


def test_query_points_matches_jax(setup):
    jm, m, surf = setup
    q = np.concatenate([surf[:500], np.random.default_rng(3).uniform(-1, 1, (700, 3))
                        .astype(np.float32), np.full((64, 3), 0.95, np.float32)])
    sdf_j, _, mask_j = jm.query_points(q, bs=256)
    sdf, _, mask = m.query_points(q, bs=256)
    np.testing.assert_array_equal(mask, mask_j)
    np.testing.assert_allclose(sdf, sdf_j, rtol=1e-5, atol=1e-6)
    assert mask[:500].all() and not mask[-64:].any()


@pytest.mark.parametrize("vs", [0.07, 0.21])
def test_query_grid_lattice_matches_jax(setup, vs):
    jm, m, _ = setup
    bbx = (np.array([-0.8, -0.8, -0.8]), np.array([0.75, 0.8, 0.77]))
    vn, vo = m.grid_shape_from_bbx(bbx, vs)
    jvn, jvo = jm.grid_shape_from_bbx(bbx, vs)
    np.testing.assert_array_equal(vn, jvn)
    np.testing.assert_array_equal(vo, jvo)
    sdf_j, _, mask_j = jm.query_grid_lattice(vn, vo, vs)
    sdf, _, mask = m.query_grid_lattice(vn, vo, vs)
    assert sdf.shape == tuple(vn) and mask.any()
    np.testing.assert_array_equal(mask, mask_j)
    np.testing.assert_allclose(sdf, sdf_j, rtol=1e-5, atol=1e-6)
    # the flat per-point grid query gives the same grid (block-major order
    # transposed back right), but for its coordinates' own rounding: an ulp
    # of a coordinate (6e-8) times the trained field's gradient (~100)
    sdf_f, _, mask_f = m.query_grid(vn, vo, vs)
    s3, _, m3 = m.assign_to_bbx(sdf_f, None, mask_f, vn)
    np.testing.assert_array_equal(m3, mask)
    np.testing.assert_allclose(s3, sdf, rtol=1e-5, atol=2e-5)


@pytest.mark.parametrize("vpn", [2, 4, 5])
def test_lattice_path_bit_equal_to_direct(setup, vpn):
    """The node-lattice path (lattice probes + index selection) and the
    direct per-point path give the same bits, chunk by chunk (JAX:
    tests/test_mesher.py::test_lattice_block_inference_matches_direct)."""
    _, m, _ = setup
    grid = m.grid
    query_level = grid.max_level - grid.featured_level_num + 1
    nodes = grid.get_octree_nodes(query_level)
    node_res = 2.0 ** (1 - query_level)
    mc = node_res / vpn
    npb = 4
    K = -(-nodes.shape[0] // npb)
    origins = (nodes - 0.5 * (node_res - mc)).astype(np.float32)
    origins = np.concatenate([origins, np.full((K * npb - len(origins), 3), 3.0, np.float32)])
    n_list = tuple(1 << max(0, lvl - query_level) for lvl in grid.levels)
    args = (m.geo_params, list(grid.features), list(grid.tables), torch.from_numpy(origins),
            float(np.float32(mc)), vpn, tuple(grid.levels), True, 0)
    sdf_d, mask_d = _infer_blocks(*args, None, npb)
    sdf_l, mask_l = _infer_blocks(*args, n_list, npb)
    assert torch.equal(mask_d, mask_l) and bool(mask_d.any())
    assert torch.equal(sdf_d, sdf_l)


def test_recon_bbx_mesh_matches_jax(setup, tmp_path):
    jm, m, _ = setup
    bbx = (np.full(3, -34 / 64), np.full(3, 34 / 64))
    mj = jm.recon_bbx_mesh(bbx, 1 / 64, str(tmp_path / "j.ply"), "")
    mesh = m.recon_bbx_mesh(bbx, 1 / 64, str(tmp_path / "p.ply"), str(tmp_path / "map.ply"),
                            save_map=True)
    assert mesh.triangles.shape[0] > 1000
    np.testing.assert_array_equal(mesh.triangles, mj.triangles)
    _assert_vertices_close(mesh.vertices, mj.vertices)
    np.testing.assert_allclose(mesh.vertex_normals, mj.vertex_normals, rtol=0, atol=1e-3)
    assert set(m.timing) == {"query", "readback", "marching", "finalize"}
    # the exported sdf map: one point per observed voxel of the dense grid
    vn, vo = m.grid_shape_from_bbx(bbx, 1 / 64)
    _, _, mask3 = m.query_grid_lattice(vn, vo, 1 / 64)
    assert io.read_point_cloud(str(tmp_path / "map.ply")).points.shape[0] == int(mask3.sum())


def test_recon_octree_mesh_matches_jax(setup, tmp_path):
    jm, m, _ = setup
    ql = m.grid.max_level - m.grid.featured_level_num + 1
    # 8 voxels a node of 1/8: a voxel of 1/64
    mj = jm.recon_octree_mesh(ql, 0.016, str(tmp_path / "j.ply"), "")
    mesh = m.recon_octree_mesh(ql, 0.016, str(tmp_path / "p.ply"), "")
    assert mesh.triangles.shape[0] > 500
    np.testing.assert_array_equal(mesh.triangles, mj.triangles)
    _assert_vertices_close(mesh.vertices, mj.vertices)
    written = io.read_ply(str(tmp_path / "p.ply"))
    np.testing.assert_array_equal(written.triangles, mesh.triangles)


def test_filter_remove_and_sdf_map_match_jax(setup, tmp_path):
    jm, m, surf = setup
    # a fan of 11 triangles and a lone triangle (tests/test_mesher.py)
    n_fan = 12
    t = np.linspace(0, 3, n_fan)
    verts = np.concatenate([np.zeros((1, 3)), np.stack([np.cos(t), np.sin(t), np.zeros(n_fan)], 1),
                            np.array([[5.0, 5, 5], [6, 5, 5], [5, 6, 5]])])
    tris = np.array([[0, i + 1, i + 2] for i in range(n_fan - 1)]
                    + [[n_fan + 1, n_fan + 2, n_fan + 3]], np.int32)
    for k in (1, 5, 12):
        got = m.filter_isolated_vertices(io.TriangleMesh(verts, tris.copy()), k)
        want = jm.filter_isolated_vertices(jio.TriangleMesh(verts, tris.copy()), k)
        np.testing.assert_array_equal(got.triangles, want.triangles)
    keep = np.arange(len(verts)) % 3 != 1
    got = _remove_vertices(io.TriangleMesh(verts, tris), keep)
    want = jax_remove_vertices(jio.TriangleMesh(verts, tris), keep)
    np.testing.assert_array_equal(got.vertices, want.vertices)
    np.testing.assert_array_equal(got.triangles, want.triangles)
    coord = surf[:128].astype(np.float64)
    sdf = np.linspace(-1, 1, 128)
    mask = np.arange(128) % 4 != 0
    m.generate_sdf_map(coord, sdf, mask, str(tmp_path / "p.ply"))
    jm.generate_sdf_map(coord, sdf, mask, str(tmp_path / "j.ply"))
    a, b = io.read_point_cloud(str(tmp_path / "p.ply")), jio.read_point_cloud(str(tmp_path / "j.ply"))
    np.testing.assert_array_equal(a.points, b.points)
    np.testing.assert_array_equal(a.intensity, b.intensity)


def test_bf16_tables_mesh_from_their_rows(setup):
    """bf16 tables (the bf16 map mode) mesh without an f32 copy of the map:
    the gathered rows widen, so the field equals that of the tables'
    exact f32 upcast."""
    _, m, _ = setup
    grid16 = HashGridHost.from_state_dict(m.grid.state_dict(), device="cpu")
    grid16.cast_features(torch.bfloat16)
    up = HashGridHost.from_state_dict(grid16.state_dict(), device="cpu")
    vn, vo = m.grid_shape_from_bbx((np.full(3, -0.7), np.full(3, 0.7)), 0.07)
    a = Mesher(m.config, grid16, m.geo_params).query_grid_lattice(vn, vo, 0.07)
    b = Mesher(m.config, up, m.geo_params).query_grid_lattice(vn, vo, 0.07)
    assert grid16.features[0].dtype == torch.bfloat16
    np.testing.assert_array_equal(a[2], b[2])
    np.testing.assert_array_equal(a[0], b[0])


def test_unported_paths_raise(setup):
    """Data-parallel meshing still raises naming its ROADMAP item; vertex
    semantics, which raised before they were ported, now run through: every
    vertex kept gets a class colour (their parity with the JAX package is
    tests/test_torch_semantic.py's)."""
    from shine_mapping_tpu_torch.models.decoder import Decoder

    jm, m, _ = setup
    with pytest.raises(NotImplementedError, match="item 14"):
        Mesher(m.config, m.grid, m.geo_params, dp_mesh=object())
    sem = Decoder(8, 32, 2, 20, generator=torch.Generator().manual_seed(3), device="cpu")
    mesh = Mesher(m.config, m.grid, m.geo_params, sem).recon_bbx_mesh(
        (np.full(3, -34 / 64), np.full(3, 34 / 64)), 1 / 64, "", "", estimate_sem=True,
        filter_free_space_vertices=False)
    assert mesh.vertices.shape[0] > 0
    assert mesh.vertex_colors.shape == mesh.vertices.shape
