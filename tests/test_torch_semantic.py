"""Semantic mapping, the city world's pool, the ``.pth`` decoder import and
time-conditioned checkpoints: the port against the JAX package.

* The batch CLI with ``semantic_on`` on tests/synth.py's world labelled by
  geometry (tests/test_semantic_e2e.py's labels: ground -> road, sphere ->
  building), run by both packages on the CPU: the port's F-score within 5
  points of the JAX driver's, and in both more than 60 % of the sphere's
  and the ground's mesh vertices coloured with their class.
* The port's dataset on a tiny city of tests/synth_city.py (3 frames of
  384 x 24 rays) with chip_smoke.py's city config gives the same pool as
  the JAX package's, labels included, and the moving-object filter drops
  the moving cars' points.
* chip_smoke.py's city writer writes make_city_dataset's files.
* A reference-layout ``.pth`` (written here with ``torch.save``) loads in
  both packages to the same decoder (sdf rtol 1e-5, atol 1e-6: the
  matmuls sum in another order; labels equal).
* A time-conditioned map's checkpoint (D + 1 decoder inputs) written by
  either package loads in the other bit for bit.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from shine_mapping_tpu.config import SHINEConfig as JaxConfig
from shine_mapping_tpu.data.dataset import LiDARDataset as JaxDataset
from shine_mapping_tpu.data.semantic_kitti import SEM_KITTI_COLOR_MAP
from shine_mapping_tpu.models import decoder as jdecoder
from shine_mapping_tpu.ops.hashgrid import HashGridHost as JaxGrid
from shine_mapping_tpu.train import trainer as jtrainer
from shine_mapping_tpu.train.optimizer import init_opt_state as jinit
from shine_mapping_tpu.utils import checkpoint as jckpt
from shine_mapping_tpu_torch import interop
from shine_mapping_tpu_torch.config import SHINEConfig
from shine_mapping_tpu_torch.data import io
from shine_mapping_tpu_torch.data.dataset import LiDARDataset
from shine_mapping_tpu_torch.eval.metrics import eval_mesh
from shine_mapping_tpu_torch.models.decoder import Decoder, load_torch_decoder
from shine_mapping_tpu_torch.ops.hashgrid import HashGridHost
from shine_mapping_tpu_torch.train import trainer
from shine_mapping_tpu_torch.train.optimizer import init_opt_state
from shine_mapping_tpu_torch.utils import checkpoint as ckpt
from tests import synth, synth_city
from tests.test_e2e import small_cfg
from tests.test_semantic_e2e import synth_sem_root  # noqa: F401  (fixture)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs files in parallel processes, and
    torch's thread pools in each would contend for the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sem_cfg(cls, root, out):
    cfg = small_cfg(root, out)
    if cls is SHINEConfig:
        cfg = SHINEConfig(**dataclasses.asdict(cfg))
        cfg.device = "cpu"
    cfg.semantic_on = True
    cfg.label_path = os.path.join(root, "labels")
    cfg.min_range = 0.5
    cfg.iters = 300
    cfg.weight_s = 1.0
    cfg.vis_freq_iters = cfg.iters
    return cfg


def _class_shares(mesh):
    """Shares of the sphere's and the ground's vertices coloured building
    (class 13) and road (class 9), as tests/test_semantic_e2e.py counts."""
    on_sphere = np.linalg.norm(mesh.vertices - synth.SPHERE_C[None, :], axis=1) \
        < synth.SPHERE_R + 0.1
    ground = np.abs(mesh.vertices[:, 2] - synth.GROUND_Z) < 0.1
    out = []
    for sel, cls in ((on_sphere, 13), (ground, 9)):
        assert sel.sum() > 20
        c = np.array(SEM_KITTI_COLOR_MAP[cls]) / 255.0
        out.append(float(np.mean(np.all(np.isclose(mesh.vertex_colors[sel], c, atol=0.02),
                                        axis=1))))
    return out


def test_semantic_batch_cli_matches_jax(synth_sem_root, tmp_path):  # noqa: F811
    from shine_mapping_tpu.cli.shine_batch import run_shine_mapping_batch as jrun
    from shine_mapping_tpu.mesher import Mesher as JaxMesher
    from shine_mapping_tpu_torch.cli.shine_batch import run_shine_mapping_batch
    from shine_mapping_tpu_torch.mesher import Mesher

    gt_path = str(tmp_path / "gt.ply")
    io.write_ply(gt_path, io.PointCloud(points=synth.gt_surface_points(100_000)))
    scores, shares = {}, {}
    for name, cls, run, mesher in (("jax", JaxConfig, jrun, JaxMesher),
                                   ("port", SHINEConfig, run_shine_mapping_batch, Mesher)):
        cfg = _sem_cfg(cls, synth_sem_root, str(tmp_path / name))
        run_path, grid, params = run(cfg=cfg)
        m = eval_mesh(f"{run_path}/mesh/mesh_iter_{cfg.iters}.ply", gt_path,
                      down_sample_res=0.05, threshold=0.2, truncation_acc=0.4,
                      truncation_com=2.0, mesh_sample_point=300_000)
        scores[name] = m["F-score (%)"]
        mesh = mesher(cfg, grid, params["geo"], params["sem"]).recon_octree_mesh(
            cfg.mc_query_level, cfg.mc_res_m, "", "", False, estimate_sem=True)
        assert mesh.vertex_colors is not None
        shares[name] = _class_shares(mesh)
        if name == "port":
            recs = [r for r in (__import__("json").loads(line)
                                for line in open(run_path + "/metrics.jsonl"))]
            assert all("loss/sem_loss" in r for r in recs)
            assert recs[-1]["loss/sem_loss"] < recs[0]["loss/sem_loss"]
    assert abs(scores["port"] - scores["jax"]) <= 5.0, scores
    for name, (sphere, ground) in shares.items():
        assert sphere > 0.6 and ground > 0.6, (name, shares)


def test_city_pool_matches_jax_with_the_moving_object_filter(tmp_path):
    root = str(tmp_path / "city")
    synth_city.make_city_dataset(root, n_frames=3, seed=0, n_az=384, n_el=24,
                                 n_blocks_x=3, n_blocks_y=2)
    raw = np.concatenate([np.fromfile(os.path.join(root, "labels", f), np.uint32)
                          for f in sorted(os.listdir(os.path.join(root, "labels")))])
    assert ((raw & 0xFFFF) == synth_city.MOVING_CAR_RAW).any()
    small = dict(vox=0.08, leaf=0.3, world_level=10)
    pools = {}
    for name, cls, ds_cls, grid_cls in (("jax", JaxConfig, JaxDataset, JaxGrid),
                                        ("port", SHINEConfig, LiDARDataset, HashGridHost)):
        cfg = chip_smoke.city_config(cls, root, str(tmp_path / name), 10, device="cpu", **small)
        # the JAX config loader does not read process.filter_moving_object
        # (ROADMAP Queue C item 3): set it as the YAML says
        assert cfg.filter_moving_object or name == "jax"
        cfg.filter_moving_object = True
        cfg.pc_radius = 80.0  # the tiny city's moving cars pass 64-68 m away
        kw = {"device": "cpu"} if name == "port" else {}
        grid = grid_cls(max_level=cfg.tree_level_world, featured_level_num=cfg.tree_level_feat,
                        feature_dim=cfg.feature_dim, feature_std=cfg.feature_std,
                        leaf_vox_size=cfg.leaf_vox_size, seed=cfg.seed,
                        init_node_capacity=1 << 14, init_corner_capacity=1 << 14, **kw)
        ds = ds_cls(cfg, grid)
        for f in ds.frame_ids():
            ds.process_frame(f)
        pools[name] = ds.pool
        if name == "port":
            cfg.filter_moving_object = False
            grid2 = grid_cls(max_level=cfg.tree_level_world,
                             featured_level_num=cfg.tree_level_feat,
                             feature_dim=cfg.feature_dim, feature_std=cfg.feature_std,
                             leaf_vox_size=cfg.leaf_vox_size, seed=cfg.seed,
                             init_node_capacity=1 << 14,
                             init_corner_capacity=1 << 14, **kw)
            ds2 = ds_cls(cfg, grid2)
            for f in ds2.frame_ids():
                ds2.process_frame(f)
            assert len(ds2.pool) > len(ds.pool)
    for f in ("coord", "sdf_label", "weight", "time", "sem_label"):
        np.testing.assert_array_equal(getattr(pools["port"], f), getattr(pools["jax"], f),
                                      err_msg=f)
    assert pools["port"].sem_label is not None and len(np.unique(pools["port"].sem_label)) >= 3


def test_smoke_city_writer_is_make_city_dataset(tmp_path):
    """chip_smoke.py's city writer (the scans' geometry cast apart, the noise
    drawn in frame order) writes make_city_dataset's files byte for byte."""
    import filecmp

    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    synth_city.make_city_dataset(a, n_frames=4, seed=0, n_az=256, n_el=16, n_blocks_x=3,
                                 n_blocks_y=2)
    chip_smoke.write_city(b, n_frames=4, n_az=256, n_el=16, blocks=(3, 2), gt_every=2,
                          workers=0)
    for d in ("velodyne", "labels"):
        names = sorted(os.listdir(os.path.join(a, d)))
        assert names == sorted(os.listdir(os.path.join(b, d))) and len(names) == 4
        for f in names:
            assert filecmp.cmp(os.path.join(a, d, f), os.path.join(b, d, f), shallow=False), f
    for f in ("poses.txt", "calib.txt"):
        assert filecmp.cmp(os.path.join(a, f), os.path.join(b, f), shallow=False), f
    assert len(io.read_ply(os.path.join(b, "gt.ply")).points) > 1000


def _reference_state(rng, D=8, H=32, n_cls=20, tc=False):
    """A reference ``Decoder.state_dict()`` layout (model/decoder.py:29-37)."""
    dims = [D + (1 if tc else 0), H, H]
    st = {}
    for i in range(2):
        st[f"layers.{i}.weight"] = torch.from_numpy(
            rng.normal(0, 0.3, (dims[i + 1], dims[i])).astype(np.float32))
        st[f"layers.{i}.bias"] = torch.from_numpy(
            rng.normal(0, 0.1, dims[i + 1]).astype(np.float32))
    st["lout.weight"] = torch.from_numpy(rng.normal(0, 0.3, (1, H)).astype(np.float32))
    st["lout.bias"] = torch.from_numpy(rng.normal(0, 0.1, 1).astype(np.float32))
    st["nclass_out.weight"] = torch.from_numpy(
        rng.normal(0, 0.3, (n_cls + 1, H)).astype(np.float32))
    st["nclass_out.bias"] = torch.from_numpy(rng.normal(0, 0.1, n_cls + 1).astype(np.float32))
    return st


@pytest.mark.parametrize("layout", ["keyed", "bare"])
def test_pth_decoder_loads_like_jax(tmp_path, layout):
    rng = np.random.default_rng(0)
    geo, sem = _reference_state(rng), _reference_state(rng)
    path = str(tmp_path / "decoders.pth")
    torch.save({"geo_decoder": geo, "sem_decoder": sem} if layout == "keyed" else geo, path)
    want = jckpt.load_decoders(path)
    got = ckpt.load_decoders(path, device="cpu")
    feat = rng.normal(0, 0.5, (500, 8)).astype(np.float32)
    for grp in ("geo", "sem"):
        dec = got[grp]
        assert isinstance(dec, Decoder)
        np.testing.assert_allclose(dec.sdf(torch.from_numpy(feat)).detach().numpy(),
                                   np.asarray(jdecoder.sdf(want[grp], jnp.asarray(feat))),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(
            dec.sem_label(torch.from_numpy(feat)).numpy(),
            np.asarray(jdecoder.sem_label(want[grp], jnp.asarray(feat))))
    # the port's Decoder keeps the reference's names: the state loads back
    assert load_torch_decoder(path, device="cpu").state_dict().keys() == geo.keys()


def _tc_world():
    rng = np.random.default_rng(4)
    surf = rng.normal(size=(3000, 3))
    surf = (0.5 * surf / np.linalg.norm(surf, axis=1, keepdims=True)).astype(np.float32)
    cfg = JaxConfig()
    cfg.tree_level_world, cfg.tree_level_feat, cfg.leaf_vox_size = 6, 3, 0.5
    cfg.time_conditioned = True
    cfg.derive()
    return surf, cfg


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_time_conditioned_checkpoint_round_trips(tmp_path, writer):
    surf, jcfg = _tc_world()
    tcfg = SHINEConfig(**{k: v for k, v in dataclasses.asdict(jcfg).items()
                          if k in {f.name for f in dataclasses.fields(SHINEConfig)}})
    tcfg.device = "cpu"
    jgrid = JaxGrid(max_level=6, featured_level_num=3, feature_dim=8, feature_std=0.05,
                    seed=0, init_node_capacity=1 << 12, init_corner_capacity=1 << 12)
    jgrid.update(surf)
    jparams = jtrainer.init_params(jcfg, jgrid, jax.random.PRNGKey(1))
    assert np.asarray(jparams["geo"]["w0"]).shape[0] == 9
    path = str(tmp_path / "model.npz")
    if writer == "port":
        grid = HashGridHost.from_state_dict(jgrid.state_dict(), device="cpu")
        params = interop.params_from_jax(jax.device_get(jparams), device="cpu")
        ckpt.save_checkpoint(path, grid, params, init_opt_state(params), 7)
        ckpt.save_decoders(str(tmp_path / "dec.npz"), params)
        g2, p2, _, it = jckpt.load_checkpoint(path, jparams, jinit(jparams))
        dec = jckpt.load_decoders(str(tmp_path / "dec.npz"))["geo"]
        want, got_geo, got_dec = params, jax.device_get(p2["geo"]), dec
        for leaf, a in interop.params_to_jax(want)["geo"].items():
            np.testing.assert_array_equal(np.asarray(got_geo[leaf]), a)
            np.testing.assert_array_equal(np.asarray(got_dec[leaf]), a)
    else:
        jckpt.save_checkpoint(path, jgrid, jparams, jinit(jparams), 7)
        jckpt.save_decoders(str(tmp_path / "dec.npz"), jparams)
        skeleton = trainer.init_params(tcfg, HashGridHost.from_state_dict(
            jgrid.state_dict(), device="cpu"))
        g2, p2, _, it = ckpt.load_checkpoint(path, skeleton, init_opt_state(skeleton),
                                             device="cpu")
        dec = ckpt.load_decoders(str(tmp_path / "dec.npz"), device="cpu")["geo"]
        for leaf, a in jax.device_get(jparams)["geo"].items():
            np.testing.assert_array_equal(interop.params_to_jax(p2)["geo"][leaf], a)
            np.testing.assert_array_equal(interop._jax_decoder(dec.state_dict())[leaf], a)
        feat = torch.from_numpy(np.random.default_rng(2).normal(size=(64, 8)).astype(np.float32))
        ts = torch.full((64,), 3.0)
        np.testing.assert_allclose(
            p2["geo"].time_conditioned_sdf(feat, ts).detach().numpy(),
            np.asarray(jdecoder.time_conditioned_sdf(jparams["geo"], jnp.asarray(feat.numpy()),
                                                     jnp.asarray(ts.numpy()))),
            rtol=1e-5, atol=1e-6)
    assert it == 7
