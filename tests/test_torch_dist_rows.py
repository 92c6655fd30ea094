"""Row-sharded tables on iid batches over two ranks (gloo, CPU), and the
continual reg over ranks, against the JAX package on two virtual devices.

The port routes each iid step's entries live to their rows' ranks
(``train_chunk(..., group=)`` on tables placed with ``table_sharding:
rows`` and no windows): the ``fused`` update through K2's row-sharded
caller on a per-step prep, ``sparse`` / ``dense`` / SGD summing the
received entries by row on their rows' ranks.  JAX runs the same modes
through GSPMD on row-sharded tables (``place_training_state(...,
table_sharding="rows")``, ``batch_sharding``).  The same seeded world,
weights, batches (JAX's draws) and shadow tables go through both, 6 steps
at adam_eps 1e-3: every loss term at rtol 1e-4, decoders, tables and
moments at rtol 1e-4 / atol 1e-5 (as ``tests/test_torch_dist.py``):

* ``rows`` in ``fused``, ``sparse``, ``dense`` and SGD, and ``dense`` with
  the consistency term, whose near points route like the batch's;
* the continual reg (``loss_reduction: sum``, as the incremental driver
  sets it) on ``rows`` (``fused``: folded by the rows' ranks; ``sparse``;
  ``dense``) and on replicated tables (iid ``fused``, fused windows,
  ``sparse``, ``dense``); the replicated runs' replicas bit-identical;
* where one rank of the port parts from JAX on this world by more than
  atol 1e-5 (the consistency term; the lazy Adam's moments under the reg,
  which JAX sums by cumsum differences), the case widens its atol to what
  one rank needs, holds one rank to it too, and holds the two ranks to
  the one rank at atol 1e-5;
* what JAX refuses on ``rows`` without routed windows (the ``pallas``
  update, bf16 moments, bf16 tables) refused by both with JAX's reasons;
* row-sharded training through growth that doubles the tables' capacity
  twice, each round against JAX's row-sharded growth run (the counterpart
  of ``tests/test_parallel.py::test_row_sharded_layout_survives_capacity_doublings``)
  and one rank of the port.

All port cases of a test run in one spawn (``tests/test_torch_dist_ranks.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from shine_mapping_tpu.parallel import mesh as jmesh
from shine_mapping_tpu.train import trainer as jtrainer
from shine_mapping_tpu.train.optimizer import init_opt_state as jinit_opt_state
from shine_mapping_tpu_torch import interop
from shine_mapping_tpu_torch.config import SHINEConfig
from shine_mapping_tpu_torch.ops.hashgrid import HashGridHost
from shine_mapping_tpu_torch.parallel.mesh import DataGroup
from shine_mapping_tpu_torch.train import trainer
from shine_mapping_tpu_torch.train.optimizer import init_opt_state
from tests.test_torch_dist import dist_worlds  # noqa: F401 (fixture)
from tests.test_torch_dist_ranks import rows_growth, spawn, train_cases
from tests.test_torch_incre import _shadow_np
from tests.test_torch_options import _jax_draws

STEPS = 6
EPS = 1e-3
REG = dict(continual_reg_on=True, lambda_forget=1e3, loss_reduction="sum")

CASES = (
    dict(name="rows_fused", kw=dict(feature_update="fused"), layout="rows", lookups=True),
    dict(name="rows_sparse", kw=dict(feature_update="sparse"), layout="rows"),
    dict(name="rows_dense", kw=dict(feature_update="dense"), layout="rows", lookups=True),
    # the consistency term's near points route like the batch's entries; its
    # cosine of near-zero point gradients parts one rank of the port from
    # JAX by up to 1.93e-4 (p), 3.92e-5 (m), 2.33e-6 (v) on this world
    dict(name="rows_dense_consistency", kw=dict(feature_update="dense",
                                                consistency_loss_on=True, consistency_count=64),
         layout="rows", lookups=True, one_rank=True, atol=dict(p=3e-4, m=6e-5, v=4e-6)),
    dict(name="rows_sgd", kw=dict(opt_adam=False), layout="rows"),
    dict(name="rows_fused_reg", kw=dict(feature_update="fused", **REG), layout="rows"),
    # JAX's lazy Adam sums a row's entries by cumsum differences, which part
    # one moment element of levels 1 and 2 of one rank of the port from JAX
    # by 1.43e-5 and 1.80e-5 (of 0.91 and 0.76) on this world
    dict(name="rows_sparse_reg", kw=dict(feature_update="sparse", **REG), layout="rows",
         one_rank=True, atol=dict(m=3e-5)),
    dict(name="rows_dense_reg", kw=dict(feature_update="dense", **REG), layout="rows"),
    dict(name="replicated_reg", kw=dict(feature_update="fused", **REG), layout="replicated",
         lookups=True),
    dict(name="replicated_sparse_reg", kw=dict(feature_update="sparse", **REG),
         layout="replicated", one_rank=True, atol=dict(m=3e-5)),
    dict(name="replicated_dense_reg", kw=dict(feature_update="dense", **REG),
         layout="replicated"),
    dict(name="replicated_reg_windows", kw=dict(feature_update="pallas", **REG),
         layout="replicated", windows=True),
)


def _mesh2():
    if len(jax.devices()) < 2:
        pytest.skip("needs 2 virtual devices")
    return Mesh(np.array(jax.devices()[:2]), ("data",))


def _jax_run(w, case, mesh):
    """JAX's 2-device train_chunk of one case from its initial state;
    returns (the state, shadow and draws handed to the port, its results)."""
    cfg_j, grid_j, pool_j = w["jax"]
    cap = 1 << int(np.ceil(np.log2(len(pool_j))))
    s = jtrainer.TrainSettings.from_config(cfg_j, grid_j.levels, adam_eps=EPS,
                                           n_used=jtrainer.used_rows_for(grid_j), **case["kw"])
    params_np = jax.device_get(jtrainer.init_params(cfg_j, grid_j, jax.random.PRNGKey(0)))
    params = jax.tree_util.tree_map(jnp.array, params_np)
    opt = jinit_opt_state(params)
    dev, n_valid = jtrainer.pool_to_device(pool_j, cap, s)
    shapes = tuple(tuple(f.shape) for f in params["features"])
    shadow_np = _shadow_np(params_np["features"]) if s.continual_reg_on else None
    shadow = (jax.tree_util.tree_map(jnp.array, shadow_np) if shadow_np is not None
              else jtrainer.empty_shadow(params["features"]))
    tables = tuple(grid_j.tables)
    wx = None
    if case.get("windows"):
        pre = jtrainer.precompute_pool_lookups(tables, dev["coord"], tuple(grid_j.levels),
                                               tuple(C for C, _ in shapes))
        wx = jtrainer.precompute_batch_windows_fused(pre, dev, int(n_valid),
                                                     jax.random.PRNGKey(1), s, shapes,
                                                     reg_cover=s.continual_reg_on)
    params, opt, tables, dev, shadow = jmesh.place_training_state(
        mesh, params, opt, tables, dev, shadow, table_sharding=case["layout"])
    key = jax.random.PRNGKey(3)
    p, o, aux = jtrainer.train_chunk(params, opt, tables, dev, shadow, n_valid, jnp.int32(0),
                                     key, s, STEPS, batch_sharding=NamedSharding(mesh, P("data")),
                                     batch_windows=wx)
    draws = {}
    if wx is None:
        mode = jtrainer.resolve_feature_update(s, shapes)
        draws = {k: v.numpy() for k, v in _jax_draws(key, s, mode, int(n_valid), STEPS).items()}
    port = dict(name=case["name"], params_np=params_np, shadow_np=shadow_np,
                layout=case["layout"], steps=STEPS,
                window_idx=None if wx is None else np.asarray(wx["idx"]), **draws)
    return port, (jax.device_get(p), jax.device_get(o), jax.device_get(aux))


@pytest.fixture(scope="module")
def runs(dist_worlds, tmp_path_factory):
    """Every case through JAX (2 devices) and the port (2 ranks, one spawn)."""
    mesh = _mesh2()
    cfg_t, grid_t, pool_t = dist_worlds["torch"]
    cap = 1 << int(np.ceil(np.log2(len(pool_t))))
    dev_t, n_t = trainer.pool_to_device(pool_t, cap, device="cpu")
    pre_t = trainer.precompute_pool_lookups(grid_t.tables, dev_t["coord"], grid_t.levels,
                                            [f.shape[0] for f in grid_t.features])
    jax_out, one, port_cases = {}, {}, []
    for case in CASES:
        port, jax_out[case["name"]] = _jax_run(dist_worlds, case, mesh)
        port["settings"] = trainer.TrainSettings.from_config(
            cfg_t, grid_t.levels, adam_eps=EPS, n_used=trainer.used_rows_for(grid_t),
            **case["kw"])
        if case.get("one_rank"):  # one rank of the port, the same draws
            params = interop.params_from_jax(port["params_np"], device="cpu")
            p, o, aux = trainer.train_chunk(
                params, init_opt_state(params), grid_t.tables, dev_t, n_t, 0, None,
                port["settings"], STEPS, pre_lookups=pre_t,
                shadow=(interop.shadow_from_jax(port["shadow_np"], device="cpu")
                        if port["shadow_np"] is not None else None),
                **{k: torch.from_numpy(port[k]) for k in ("batch_indices", "near_indices",
                                                          "near_shifts") if k in port})
            one[case["name"]] = dict(params=interop.params_to_jax(p),
                                     opt=interop.opt_state_to_jax(o))
        if not case.get("lookups", case.get("windows")):
            port["pre"] = None  # live hash probes
        port_cases.append(port)
    d = tmp_path_factory.mktemp("dist_rows_spec")
    spec, out = str(d / "spec.pt"), str(d / "out.pt")
    torch.save({"world": dict(tables=list(grid_t.tables), pool=dev_t, n_valid=n_t, pre=pre_t),
                "cases": port_cases}, spec)
    spawn(train_cases, spec, out)
    return jax_out, one, torch.load(out, weights_only=False)


@pytest.mark.parametrize("name", [c["name"] for c in CASES])
def test_two_rank_rows_and_reg_match_jax(runs, name):
    """Two ranks against JAX's 2-device train_chunk: every loss term (the
    reg's included), decoders, tables and moments; replicated replicas
    bit-identical on every rank."""
    jax_out, one, port = runs
    case = next(c for c in CASES if c["name"] == name)
    p_j, o_j, aux_j = jax_out[name]
    got = port[name]
    for k in ("mean", "last"):
        for term, val in aux_j[k].items():
            np.testing.assert_allclose(got["aux"][k][term], float(val), rtol=1e-4,
                                       atol=1e-7, err_msg=f"{k} {term}")
    if "reg_loss" in aux_j["last"]:
        assert got["aux"]["last"]["reg_loss"] > 0
    for grp in ("geo", "sem"):
        for leaf in p_j[grp]:
            np.testing.assert_allclose(got["params"][grp][leaf], p_j[grp][leaf], rtol=1e-4,
                                       atol=1e-5, err_msg=f"{grp}.{leaf}")
    assert got["opt"]["step"] == STEPS

    def tables(r):
        return {"p": r["params"]["features"], "m": r["opt"]["m"]["features"],
                "v": r["opt"]["v"]["features"]}

    want = {"p": p_j["features"], "m": o_j.m["features"], "v": o_j.v["features"]}
    for what, a_l in tables(got).items():
        atol = case.get("atol", {}).get(what, 1e-5)
        for i, (a, b) in enumerate(zip(a_l, want[what])):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4, atol=atol,
                                       err_msg=f"{what} features[{i}]")
            if name in one:
                # the widened atol is what one rank of the port needs against
                # JAX, and the two ranks stay with the one rank at 1e-5
                c = tables(one[name])[what][i]
                np.testing.assert_allclose(c, np.asarray(b), rtol=1e-4, atol=atol,
                                           err_msg=f"one rank: {what} features[{i}]")
                np.testing.assert_allclose(a, c, rtol=1e-4, atol=1e-5,
                                           err_msg=f"against one rank: {what} features[{i}]")
    if got["replicas_equal"] is not None:
        assert got["replicas_equal"], "the replicas parted"
    comm = got["comm"]
    if name.startswith("rows"):  # live routing: the counts and the cells exchanged
        assert comm["uneven_block"][0] > 0 and comm["all_to_all"][0] > 0
    else:
        assert comm["uneven_block"][0] == 0


# JAX's reasons (shine_mapping_tpu/train/trainer.py:806-835)
REFUSED = (
    (dict(feature_update="pallas"), False, False, "needs replicated feature tables"),
    (dict(feature_update="fused"), True, False, "moments_bf16 requires feature_update: pallas"),
    # JAX's moments take the tables' bf16, and bf16 moments need pallas
    (dict(feature_update="fused"), True, True, "moments_bf16 requires feature_update: pallas"),
)


@pytest.mark.parametrize("kw,moments_bf16,params_bf16,reason", REFUSED,
                         ids=["pallas", "bf16_moments", "bf16_tables"])
def test_rows_on_iid_batches_refuse_what_jax_refuses(dist_worlds, kw, moments_bf16,
                                                     params_bf16, reason):
    """The ``pallas`` update, bf16 moments and bf16 tables on row-sharded
    tables without routed windows: ValueError in both packages, with the
    same reason, before any step (the port's before any collective)."""
    mesh = _mesh2()
    cfg_j, grid_j, pool_j = dist_worlds["jax"]
    cap = 1 << int(np.ceil(np.log2(len(pool_j))))
    s = jtrainer.TrainSettings.from_config(cfg_j, grid_j.levels, **kw)
    params = jtrainer.init_params(cfg_j, grid_j, jax.random.PRNGKey(0))
    if params_bf16:
        params = dict(params, features=tuple(f.astype(jnp.bfloat16) for f in params["features"]))
    opt = jinit_opt_state(params, moments_bf16=moments_bf16)
    dev, n_valid = jtrainer.pool_to_device(pool_j, cap, s)
    params, opt, tables, dev, shadow = jmesh.place_training_state(
        mesh, params, opt, tuple(grid_j.tables), dev, jtrainer.empty_shadow(params["features"]),
        table_sharding="rows")
    with pytest.raises(ValueError, match=reason):
        jtrainer.train_chunk(params, opt, tables, dev, shadow, n_valid, jnp.int32(0),
                             jax.random.PRNGKey(0), s, 1,
                             batch_sharding=NamedSharding(mesh, P("data")))

    cfg_t, grid_t, pool_t = dist_worlds["torch"]
    s_t = trainer.TrainSettings.from_config(cfg_t, grid_t.levels, **kw)
    p_t = trainer.init_params(cfg_t, grid_t, torch.Generator().manual_seed(0))
    # rank 0's blocks of the tables (the checks raise before any collective)
    p_t["features"] = [f[: f.shape[0] // 2].clone().to(
        torch.bfloat16 if params_bf16 else torch.float32) for f in p_t["features"]]
    dev_t, n_t = trainer.pool_to_device(pool_t, cap, device="cpu")
    grp = DataGroup(rank=0, world=2, device=torch.device("cpu"), table_sharding="rows")
    with pytest.raises(ValueError, match=reason):
        trainer.train_chunk(p_t, init_opt_state(p_t, moments_bf16=moments_bf16),
                            grid_t.tables, dev_t, n_t, 0, torch.Generator(), s_t, 1, group=grp)
    if params_bf16:  # with f32 moments: the stochastic rounding needs fused windows
        with pytest.raises(ValueError, match="params_bf16 requires fused batch windows"):
            trainer.train_chunk(p_t, init_opt_state(p_t), grid_t.tables, dev_t, n_t, 0,
                                torch.Generator(), s_t, 1, group=grp)


def test_row_sharded_tables_survive_capacity_doublings(tmp_path):
    """Growth -> place again -> train, three rounds on a tiny map whose
    tables double at least twice, in both packages from the same state
    (JAX: ``place_training_state(table_sharding="rows")`` and
    ``batch_sharding`` on 2 devices, as
    ``tests/test_parallel.py::test_row_sharded_layout_survives_capacity_doublings``;
    the port: 2 ranks, rows, ``fused``, live routing), each growing from
    its own trained tables: every round's loss at rtol 1e-4, decoders,
    tables and moments at rtol 1e-4 / atol 1e-5 against JAX's, and against
    one rank of the port trained from the round's same state; every doubled
    capacity splits into two blocks."""
    from shine_mapping_tpu.cli.common import pad_opt_state_features as jpad
    from shine_mapping_tpu.ops.hashgrid import HashGridHost as JaxGrid
    from shine_mapping_tpu.train.optimizer import OptState as JaxOpt
    from tests.test_trainer import default_cfg, make_sphere_pool

    mesh = _mesh2()
    pool, surf = make_sphere_pool(1200, radius=0.35)
    cfg_j = default_cfg(bs=512)
    grid_kw = dict(max_level=cfg_j.tree_level_world, featured_level_num=cfg_j.tree_level_feat,
                   feature_dim=cfg_j.feature_dim, feature_std=cfg_j.feature_std,
                   seed=cfg_j.seed, init_node_capacity=1 << 9, init_corner_capacity=1 << 9)
    rng = np.random.default_rng(11)
    extras = []
    for rnd in range(2):
        e = rng.standard_normal((1500, 3))
        extras.append(e / np.linalg.norm(e, axis=1, keepdims=True) * (0.55 + 0.12 * rnd))

    # JAX: the rows layout through the growth, its batches drawn per round
    grid_j = JaxGrid(**grid_kw)
    grid_j.update(surf)
    kw = dict(sigma_sigmoid=0.05, feature_update="fused", adam_eps=EPS)
    s_j = jtrainer.TrainSettings.from_config(cfg_j, grid_j.levels, **kw)
    params_np = jax.device_get(jtrainer.init_params(cfg_j, grid_j, jax.random.PRNGKey(0)))
    params = jax.tree_util.tree_map(jnp.array, params_np)
    opt = jinit_opt_state(params)
    dev, n_valid = jtrainer.pool_to_device(pool, 1 << 13, s_j)
    want, draws = [], []
    for rnd in range(3):
        key = jax.random.PRNGKey(rnd)
        p, o, tb, pl, sh = jmesh.place_training_state(
            mesh, params, opt, tuple(grid_j.tables), dev,
            jtrainer.empty_shadow(params["features"]), table_sharding="rows")
        p, o, aux = jtrainer.train_chunk(p, o, tb, pl, sh, n_valid, jnp.int32(0), key, s_j, 2,
                                         batch_sharding=NamedSharding(mesh, P("data")))
        draws.append(_jax_draws(key, s_j, "fused", int(n_valid), 2)["batch_indices"].numpy())
        p, o = jax.device_get(p), jax.device_get(o)
        want.append((p, o, float(aux["mean"]["total_loss"])))
        if rnd == 2:
            break
        grid_j.features = [jnp.array(f) for f in p["features"]]
        grid_j.update(extras[rnd])
        params = dict(jax.tree_util.tree_map(jnp.array, p), features=tuple(grid_j.features))
        opt = jpad(JaxOpt(m=jax.tree_util.tree_map(jnp.array, o.m),
                          v=jax.tree_util.tree_map(jnp.array, o.v), step=jnp.asarray(o.step)),
                   params)

    cfg = SHINEConfig()
    for k in ("tree_level_world", "tree_level_feat", "leaf_vox_size", "bs", "lr"):
        setattr(cfg, k, getattr(cfg_j, k))
    cfg.derive()
    cfg.scale = 1.0
    s = trainer.TrainSettings.from_config(cfg, HashGridHost(**grid_kw, device="cpu").levels,
                                          **kw)
    dev_t, n_t = trainer.pool_to_device(pool, 1 << 13, device="cpu")
    spec, out = str(tmp_path / "spec.pt"), str(tmp_path / "out.pt")
    torch.save(dict(settings=s, grid_kw=grid_kw, surf=surf, pool=dev_t, n_valid=n_t,
                    extras=extras, params_np=params_np, batch_indices=draws), spec)
    spawn(rows_growth, spec, out)
    rounds = torch.load(out, weights_only=False)
    caps = [r["capacity"] for r in rounds]
    assert caps[-1] >= 4 * caps[0], f"expected >= 2 doublings, got {caps}"
    for rnd, (r, (p_j, o_j, loss_j)) in enumerate(zip(rounds, want)):
        assert [C * 2 for C, _ in r["shapes"]] == r["whole"]
        np.testing.assert_allclose(r["ranks"]["loss"], loss_j, rtol=1e-4)
        np.testing.assert_allclose(r["ranks"]["loss"], r["one"]["loss"], rtol=1e-5)
        for leaf in p_j["geo"]:
            np.testing.assert_allclose(r["ranks"]["params"]["geo"][leaf], p_j["geo"][leaf],
                                       rtol=1e-4, atol=1e-5, err_msg=f"round {rnd} geo.{leaf}")
        for ref, tabs in (("jax", (p_j["features"], o_j.m["features"], o_j.v["features"])),
                          ("one rank", (r["one"]["params"]["features"],
                                        r["one"]["opt"]["m"]["features"],
                                        r["one"]["opt"]["v"]["features"]))):
            got = (r["ranks"]["params"]["features"], r["ranks"]["opt"]["m"]["features"],
                   r["ranks"]["opt"]["v"]["features"])
            for what, a_l, b_l in zip("pmv", got, tabs):
                for i, (a, b) in enumerate(zip(a_l, b_l)):
                    np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4, atol=1e-5,
                                               err_msg=f"round {rnd} {ref}: {what}[{i}]")
