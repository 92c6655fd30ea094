"""Training over two ranks (gloo, CPU) against the JAX package on two
virtual devices.

The port runs one process per rank (``parallel.mesh``, ``train_chunk(...,
group=)``), the JAX package one controller over a 2-device mesh
(``batch_sharding``; ``tests/conftest.py``'s virtual CPU devices).  The same
seeded world, weights and batches (the JAX package's draws and windows)
go through both:

* K2's row-sharded caller: the port's plain shard step per shard against
  JAX ``fused_adam_packed_shard(use_pallas=False)`` on one level (where the
  two row splits coincide), rtol 1e-6, and the shards concatenated against
  one unsharded port step on three levels;
* the routing: every found entry routed exactly once to its row's rank,
  and the served rows reassembling the direct gather (JAX's
  ``test_routing_reconstructs_direct_gather``);
* trajectories of 6 steps at adam_eps 1e-3 (rtol 1e-4 / atol 1e-5, as
  ``tests/test_torch_trainer.py``), every loss term too: replicated tables
  on iid batches (K2, and lazy Adam: the touched rows summed across ranks)
  and on fused windows, row-sharded tables on routed windows; bf16 tables on routed windows in aggregate (JAX reseeds each
  shard's rounding, the port keys it by the whole table's element);
  replicas bit-identical on every rank.

All port cases run in one spawn (``tests/test_torch_dist_ranks.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from shine_mapping_tpu.ops import adam_kernel as jak
from shine_mapping_tpu.parallel import mesh as jmesh
from shine_mapping_tpu.train import trainer as jtrainer
from shine_mapping_tpu.train.optimizer import init_opt_state as jinit_opt_state
from shine_mapping_tpu_torch import interop
from shine_mapping_tpu_torch.ops import adam_kernel as ak
from shine_mapping_tpu_torch.train import trainer
from tests.test_torch_dist_ranks import spawn, train_cases
from tests.test_torch_trainer import (BS, HashGridHost, JaxConfig, JaxDataset, JaxGrid,
                                      LiDARDataset, SHINEConfig, _cfg, _grid,
                                      _jax_batch_indices)
from tests import synth

STEPS = 6
EPS = 1e-3


@pytest.fixture(scope="module")
def dist_worlds(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("synth_dist"))
    synth.make_kitti_dataset(root, n_frames=2)
    out = {}
    for name, cfg_cls, ds_cls, grid in (
        ("jax", JaxConfig, JaxDataset, lambda c: _grid(JaxGrid, c)),
        ("torch", SHINEConfig, LiDARDataset, lambda c: _grid(HashGridHost, c, device="cpu")),
    ):
        cfg = _cfg(cfg_cls, root)
        g = grid(cfg)
        ds = ds_cls(cfg, g)
        for f in ds.frame_ids():
            ds.process_frame(f)
        out[name] = (cfg, g, ds.pool)
    out["root"] = root
    return out


def _mesh2():
    if len(jax.devices()) < 2:
        pytest.skip("needs 2 virtual devices")
    return Mesh(np.array(jax.devices()[:2]), ("data",))


def _jax_run(w, case, mesh):
    """JAX's 2-device train_chunk of one case; returns (params, opt, aux)
    as numpy, and the windows' indices where the case has windows."""
    cfg_j, grid_j, pool_j = w["jax"]
    cap = 1 << int(np.ceil(np.log2(len(pool_j))))
    s = jtrainer.TrainSettings.from_config(cfg_j, grid_j.levels, adam_eps=EPS,
                                           n_used=jtrainer.used_rows_for(grid_j),
                                           **case["jax_kw"])
    params = jtrainer.init_params(cfg_j, grid_j, jax.random.PRNGKey(0))
    params_np = jax.device_get(params)
    params = jax.tree_util.tree_map(jnp.array, params_np)
    if case.get("bf16"):
        params = dict(params, features=tuple(f.astype(jnp.bfloat16) for f in params["features"]))
    opt = jinit_opt_state(params, moments_bf16=bool(case.get("bf16")))
    dev, n_valid = jtrainer.pool_to_device(pool_j, cap, s)
    feat_shapes = tuple(tuple(f.shape) for f in params["features"])
    tables = tuple(grid_j.tables)
    shadow = jtrainer.empty_shadow(params["features"])
    wx = None
    if case["windows"]:
        pre = jtrainer.precompute_pool_lookups(tables, dev["coord"], tuple(grid_j.levels),
                                               tuple(C for C, _ in feat_shapes))
        wx = jtrainer.precompute_batch_windows_fused(
            pre, dev, int(n_valid), jax.random.PRNGKey(1), s, feat_shapes,
            shards=2 if case["layout"] == "rows" else 0)
    params, opt, tables, dev, shadow = jmesh.place_training_state(
        mesh, params, opt, tables, dev, shadow, table_sharding=case["layout"])
    key = jax.random.PRNGKey(3)
    p, o, aux = jtrainer.train_chunk(params, opt, tables, dev, shadow, n_valid, jnp.int32(0),
                                     key, s, STEPS, batch_sharding=NamedSharding(mesh, P("data")),
                                     batch_windows=wx)
    idx = None if wx is None else np.asarray(wx["idx"])
    bi = None if wx is not None else _jax_batch_indices(key, n_valid, STEPS, BS)
    return params_np, jax.device_get(p), jax.device_get(o), jax.device_get(aux), idx, bi


CASES = (
    dict(name="iid_k2", jax_kw=dict(feature_update="pallas", fuse_update_levels=True),
         windows=False, layout="replicated"),
    dict(name="windows", jax_kw=dict(feature_update="pallas"), windows=True,
         layout="replicated"),
    dict(name="routed", jax_kw=dict(feature_update="pallas"), windows=True, layout="rows"),
    dict(name="routed_bf16", jax_kw=dict(feature_update="pallas"), windows=True,
         layout="rows", bf16=True),
    dict(name="sparse", jax_kw=dict(feature_update="sparse"), windows=False,
         layout="replicated"),
)


@pytest.fixture(scope="module")
def runs(dist_worlds, tmp_path_factory):
    """Every case through JAX (2 devices) and the port (2 ranks, one spawn)."""
    mesh = _mesh2()
    cfg_t, grid_t, pool_t = dist_worlds["torch"]
    cap = 1 << int(np.ceil(np.log2(len(pool_t))))
    dev_t, n_t = trainer.pool_to_device(pool_t, cap, device="cpu")
    pre_t = trainer.precompute_pool_lookups(grid_t.tables, dev_t["coord"], grid_t.levels,
                                            [f.shape[0] for f in grid_t.features])
    jax_out, port_cases = {}, []
    for case in CASES:
        params_np, p, o, aux, idx, bi = _jax_run(dist_worlds, case, mesh)
        jax_out[case["name"]] = (p, o, aux)
        s_t = trainer.TrainSettings.from_config(cfg_t, grid_t.levels, adam_eps=EPS,
                                                n_used=trainer.used_rows_for(grid_t),
                                                **case["jax_kw"])
        port_cases.append(dict(name=case["name"], settings=s_t, params_np=params_np,
                               layout=case["layout"], steps=STEPS, window_idx=idx,
                               batch_indices=bi, bf16_tables=case.get("bf16", False),
                               bf16_moments=case.get("bf16", False)))
    d = tmp_path_factory.mktemp("dist_spec")
    spec, out = str(d / "spec.pt"), str(d / "out.pt")
    torch.save({"world": dict(tables=list(grid_t.tables), pool=dev_t, n_valid=n_t, pre=pre_t),
                "cases": port_cases}, spec)
    spawn(train_cases, spec, out)
    return jax_out, torch.load(out, weights_only=False)


@pytest.mark.parametrize("name", ["iid_k2", "windows", "routed", "sparse"])
def test_two_rank_trajectory_matches_jax(runs, name):
    """Two ranks against JAX's 2-device train_chunk: every loss term,
    decoders, tables and moments (replicas bit-identical on every rank)."""
    jax_out, port = runs
    p_j, o_j, aux_j = jax_out[name]
    got = port[name]
    for k in ("mean", "last"):
        for term, val in aux_j[k].items():
            np.testing.assert_allclose(got["aux"][k][term], float(val), rtol=1e-4,
                                       atol=1e-7, err_msg=f"{k} {term}")
    for grp in ("geo", "sem"):
        for leaf in p_j[grp]:
            np.testing.assert_allclose(got["params"][grp][leaf], p_j[grp][leaf], rtol=1e-4,
                                       atol=1e-5, err_msg=f"{grp}.{leaf}")
    assert got["opt"]["step"] == STEPS
    for i in range(len(p_j["features"])):
        for what, a, b in (("p", got["params"]["features"][i], p_j["features"][i]),
                           ("m", got["opt"]["m"]["features"][i], o_j.m["features"][i]),
                           ("v", got["opt"]["v"]["features"][i], o_j.v["features"][i])):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4, atol=1e-5,
                                       err_msg=f"{what} features[{i}]")
    if got["replicas_equal"] is not None:
        assert got["replicas_equal"], "the replicas parted"


def test_two_rank_bf16_tables_in_aggregate(runs):
    """bf16 tables and moments on routed windows: the loss and the decoders
    as the f32 cases, the tables within a few bf16 quanta (JAX reseeds each
    shard's stochastic rounding; the port keys it by the whole table)."""
    jax_out, port = runs
    p_j, _, aux_j = jax_out["routed_bf16"]
    got = port["routed_bf16"]
    np.testing.assert_allclose(got["aux"]["mean"]["total_loss"],
                               float(aux_j["mean"]["total_loss"]), rtol=1e-3)
    for a, b in zip(got["params"]["features"], p_j["features"]):
        a = np.asarray(a, np.float32)
        b = np.asarray(b, np.float32)
        tol = np.maximum(np.abs(b) * 2.0 ** -7, 1e-6)
        d = np.abs(a - b)
        assert (d <= tol).mean() > 0.9
        assert (d <= 4 * tol).mean() > 0.99


def _shard_inputs(rng, C, D, L, M, n):
    tabs = [[rng.normal(0, 0.1, (C, D)).astype(np.float32) for _ in range(L)],
            [rng.normal(0, 0.01, (C, D)).astype(np.float32) for _ in range(L)],
            [np.abs(rng.normal(0, 1e-4, (C, D))).astype(np.float32) for _ in range(L)]]
    rows = [rng.integers(0, C - 1, M) for _ in range(L)]
    for r in rows:
        r[M // 2: M // 2 + M // 8] = r[: M // 8]  # duplicates
    grads = [rng.normal(0, 1e-3, (M, D)).astype(np.float32) for _ in range(L)]
    return tabs, rows, grads


def _port_shard(tabs, rows, grads, k, n, C, D, moments_bf16=False, perm=None):
    """Shard k's blocks after one plain shard step on its entries."""
    L = len(tabs[0])
    b = C // n
    mdt = torch.bfloat16 if moments_bf16 else torch.float32
    p = [torch.from_numpy(t[k * b:(k + 1) * b].copy()) for t in tabs[0]]
    m = [torch.from_numpy(t[k * b:(k + 1) * b].copy()).to(mdt) for t in tabs[1]]
    v = [torch.from_numpy(t[k * b:(k + 1) * b].copy()).to(mdt) for t in tabs[2]]
    rl, gl = [], []
    for l in range(L):
        sel = rows[l] // b == k
        rl.append(rows[l][sel] - k * b + l * b)
        gl.append(grads[l][sel])
    r = torch.from_numpy(np.concatenate(rl)).to(torch.int32)
    g = torch.from_numpy(np.concatenate(gl))
    if perm is not None:
        o = torch.from_numpy(perm(len(r)))
        r, g = r[o], g[o]
    ak.fused_adam_shard_plain(p, m, v, r, g, 0.01, 0.3439, 0.0394, [1.0] * L, [k * b] * L,
                              eps=1e-15, grads_bf16=moments_bf16)
    return p, m, v


@pytest.mark.parametrize("moments_bf16", [False, True], ids=["f32", "bf16m"])
def test_shard_plain_matches_jax_packed_shard(moments_bf16):
    """One level of 2^13 rows of 8 over 2 shards: each port shard's plain
    step against JAX ``fused_adam_packed_shard(use_pallas=False)`` on the
    same shard (with one level the port's per-level split and JAX's split of
    the packed table give the same rows), rtol 1e-6."""
    rng = np.random.default_rng(0)
    C, D, n, M = 1 << 13, 8, 2, 3000
    tabs, rows, grads = _shard_inputs(rng, C, D, 1, M, n)
    PACK = 128 // D
    R = C * D // 128
    for k in range(n):
        p, m, v = _port_shard(tabs, rows, grads, k, n, C, D, moments_bf16)
        sel = rows[0] // (C // n) == k
        r_k = rows[0][sel]
        g128 = jak.narrow_to_lanes(jnp.asarray(grads[0][sel]), jnp.asarray(r_k), D)
        R_loc, tb, w, T, lvl = jak.shard_geometry(((C, D),), n, len(r_k))
        prow = jnp.asarray(r_k // PACK - k * R_loc, jnp.int32)
        pre = jak.entry_prep_local(prow, jnp.zeros(len(r_k), bool), R_loc, tb, w)
        mdt = jnp.bfloat16 if moments_bf16 else jnp.float32
        blk = slice(k * R_loc, (k + 1) * R_loc)
        pj, mj, vj = jak.fused_adam_packed_shard(
            jnp.asarray(tabs[0][0].reshape(R, 128)[blk]),
            jnp.asarray(tabs[1][0].reshape(R, 128)[blk]).astype(mdt),
            jnp.asarray(tabs[2][0].reshape(R, 128)[blk]).astype(mdt), g128, pre,
            jnp.asarray(lvl[k]), jnp.float32(0.01), jnp.float32(0.3439), jnp.float32(0.0394),
            ((C, D),), (1.0,), n, eps=1e-15, use_pallas=False, grads_bf16=moments_bf16)
        for what, a, b in (("p", p[0], pj), ("m", m[0], mj), ("v", v[0], vj)):
            np.testing.assert_allclose(a.float().numpy(),
                                       np.asarray(b, np.float32).reshape(-1, D), rtol=1e-6,
                                       atol=1e-12, err_msg=f"shard {k} {what}")


@pytest.mark.parametrize("variant", ["f32", "bf16m", "bf16p"])
def test_shards_concatenated_equal_unsharded_step(variant):
    """Three levels over 2 shards, entries shuffled on each shard: the
    blocks concatenated against one unsharded step (``fused_adam_multi``'s
    plain version) on the same entries.  f32: the sum order within a row
    differs (rtol 1e-6, atol 1e-9: an ulp of a sum of ~1e-3 gradients);
    bf16 moments and bf16 p with stochastic rounding
    (keyed by the whole table's element): bit-equal."""
    rng = np.random.default_rng(1)
    C, D, L, n, M = 1 << 12, 8, 3, 2, 2000
    tabs, rows, grads = _shard_inputs(rng, C, D, L, M, n)
    pdt = torch.bfloat16 if variant == "bf16p" else torch.float32
    mdt = torch.float32 if variant == "f32" else torch.bfloat16
    ps = [torch.from_numpy(t.copy()).to(pdt) for t in tabs[0]]
    ms = [torch.from_numpy(t.copy()).to(mdt) for t in tabs[1]]
    vs = [torch.from_numpy(t.copy()).to(mdt) for t in tabs[2]]
    blocks = [[interop.shard_rows(tab, k, n) for tab in (ps, ms, vs)] for k in range(n)]
    seed = 5 if variant == "bf16p" else None
    ak.fused_adam_multi(ps, ms, vs, [torch.from_numpy(r) for r in rows],
                        [torch.from_numpy(g) for g in grads], 0.01, 0.3439, 0.0394, [1.0] * L,
                        sr_seed=seed, grads_bf16=variant != "f32")
    b = C // n
    out = []
    for k in range(n):
        p, m, v = blocks[k]
        rl, gl = [], []
        for l in range(L):
            sel = rows[l] // b == k
            rl.append(rows[l][sel] - k * b + l * b)
            gl.append(grads[l][sel])
        perm = rng.permutation(sum(len(x) for x in rl))
        r = torch.from_numpy(np.concatenate(rl)[perm]).to(torch.int32)
        g = torch.from_numpy(np.concatenate(gl)[perm])
        ak.fused_adam_shard(p, m, v, r, g, 0.01, 0.3439, 0.0394, [1.0] * L,
                            ak.shard_row_base([(C, D)] * L, n, k), sr_seed=seed,
                            grads_bf16=variant != "f32")
        out.append((p, m, v))
    for i, whole in enumerate((ps, ms, vs)):
        got = interop.gather_rows([o[i] for o in out])
        for l in range(L):
            if variant == "f32":
                np.testing.assert_allclose(got[l].numpy(), whole[l].numpy(), rtol=1e-6,
                                           atol=1e-9)
            else:
                assert torch.equal(got[l], whole[l]), f"table {i} level {l}"


def test_routing_reconstructs_direct_gather(dist_worlds):
    """The routed windows' invariants on the port's layout over 2 and 4
    ranks: every found entry routed exactly once to its row's rank and
    received by that rank's shard prep, and for every window and rank the
    rows served through the all-to-all reassembling the direct gather of
    every found entry (misses: the zero row)."""
    cfg_t, grid_t, pool_t = dist_worlds["torch"]
    cap = 1 << int(np.ceil(np.log2(len(pool_t))))
    dev, n_valid = trainer.pool_to_device(pool_t, cap, device="cpu")
    shapes = [tuple(f.shape) for f in grid_t.features]
    pre = trainer.precompute_pool_lookups(grid_t.tables, dev["coord"], grid_t.levels,
                                          [C for C, _ in shapes])
    s = trainer.TrainSettings.from_config(cfg_t, grid_t.levels, feature_update="pallas")
    feats = [f.clone() for f in grid_t.features]
    L, D = len(shapes), shapes[0][1]
    for n in (2, 4):
        win = trainer.precompute_batch_windows(pre, n_valid, torch.Generator().manual_seed(0),
                                               s, shapes, shards=n)
        rt = win.route
        b = s.bs // n
        for w_i in range(min(win.n_windows, 3)):
            idx = win.idx[w_i]
            found = torch.cat([pre[l][1][idx].repeat_interleave(8) for l in range(L)])
            assert int((rt.serve[w_i] >= 0).sum()) == int(found.sum())
            assert int((rt.owner_sel[w_i] < L * b * 8).sum()) == int(found.sum())
            assert int((rt.pre.rows[w_i] < 2 ** 31 - 1).sum()) == int(found.sum())
            sends = [torch.stack([feats[l][d * (C // n):(d + 1) * (C // n)][
                rt.serve[w_i, d, :, l].long().clamp(min=0)] for l, (C, _) in enumerate(shapes)],
                dim=1) for d in range(n)]  # rank d's (n_s, L, E, D)
            for s_r in range(n):
                recv = torch.stack([sends[d][s_r] for d in range(n)])
                flat = torch.cat([recv.reshape(-1, D), torch.zeros(1, D)])
                G = flat[rt.recv_inv[w_i, s_r].long()].reshape(L, b, 8, D)
                loc = idx[s_r * b:(s_r + 1) * b]
                for l in range(L):
                    direct = feats[l][pre[l][0][loc].long()]
                    hit = pre[l][1][loc]
                    assert torch.equal(G[l][hit], direct[hit])
                    assert (G[l][~hit] == 0).all()


def _routing_world(dist_worlds):
    cfg_t, grid_t, pool_t = dist_worlds["torch"]
    cap = 1 << int(np.ceil(np.log2(len(pool_t))))
    dev, n_valid = trainer.pool_to_device(pool_t, cap, device="cpu")
    shapes = [tuple(f.shape) for f in grid_t.features]
    pre = trainer.precompute_pool_lookups(grid_t.tables, dev["coord"], grid_t.levels,
                                          [C for C, _ in shapes])
    s = trainer.TrainSettings.from_config(cfg_t, grid_t.levels, feature_update="pallas")
    return pre, n_valid, s, shapes


def _held(win):
    rt = win.route
    return (win.idx.nbytes + rt.serve.nbytes + rt.recv_inv.nbytes + rt.owner_sel.nbytes
            + rt.pre.rows.nbytes + rt.pre.order.nbytes + rt.pre.tile_off.nbytes
            + rt.pre.dropped.nbytes)


@pytest.mark.parametrize("n", [2, 4])
def test_estimate_windows_bytes_is_per_rank(dist_worlds, n):
    """The routed windows' estimate is one rank's share and bounds what
    every rank holds after placement, over 2 and 4 ranks.  The world is
    skewed as the row split makes it: the used heads fill the tables' first
    rows, so rank 0 serves most entries, and over 4 ranks the largest cell
    E passes twice the mean cell (what the estimate once assumed) on its
    way to its bound 8 bs / n."""
    pre, n_valid, s, shapes = _routing_world(dist_worlds)
    est = trainer.estimate_windows_bytes(n_valid, s, shapes, shards=n)
    if n > 2:
        assert est < trainer.estimate_windows_bytes(n_valid, s, shapes, shards=n // 2)
    win = trainer.precompute_batch_windows(pre, n_valid, torch.Generator().manual_seed(0), s,
                                           shapes, shards=n)
    assert win.route.E <= 8 * (s.bs // n)
    if n == 4:  # over 2 ranks twice the mean cell is the bound itself
        assert win.route.E > 2 * -(-s.bs * 8 // (n * n)), "the world is not skewed"
    for k in range(n):
        placed = dataclasses.replace(win, route=win.route.local_part(k))
        assert _held(placed) <= est


@pytest.mark.parametrize("n", [2, 4])
def test_rank_routing_equals_its_part_of_the_whole(dist_worlds, n):
    """``precompute_batch_windows(..., shards=n, rank=k)`` (a training rank
    routes only its own cells) gives rank k's part of the routing for every
    rank, bit for bit: served rows, receive map, send selection, the shard
    prep and E."""
    pre, n_valid, s, shapes = _routing_world(dist_worlds)
    whole = trainer.precompute_batch_windows(pre, n_valid, torch.Generator().manual_seed(0),
                                             s, shapes, shards=n)
    for k in range(n):
        mine = trainer.precompute_batch_windows(pre, n_valid, torch.Generator().manual_seed(0),
                                                s, shapes, shards=n, rank=k).route
        want = whole.route.local_part(k)
        assert (mine.rank, mine.n, mine.E, mine.sizes) == (want.rank, want.n, want.E, want.sizes)
        for f in ("serve", "recv_inv", "owner_sel"):
            assert torch.equal(getattr(mine, f), getattr(want, f)), f
        assert mine.pre.sorted_by_row and mine.pre[4:] == want.pre[4:]
        for f in ("rows", "order", "tile_off", "dropped"):
            assert torch.equal(getattr(mine.pre, f), getattr(want.pre, f)), f


@pytest.mark.parametrize("prep", ["kernel_like", "sorted"])
def test_deterministic_sum_refuses_an_unsorted_prep(prep):
    """The deterministic sum reads each row's entries as one run, so it
    takes only a prep sorted by row: one that is not (csrc/entry_prep.cu's,
    binned in the order its atomics land) raises before any step; the
    sorted plain prep steps as the call without a prep does."""
    rng = np.random.default_rng(3)
    C, D, L, M = 1 << 10, 8, 2, 500
    tabs, rows, grads = _shard_inputs(rng, C, D, L, M, 2)
    rows_t = [torch.from_numpy(r) for r in rows]
    g_t = [torch.from_numpy(g) for g in grads]

    def state():
        return [[torch.from_numpy(t.copy()) for t in tabs[k]] for k in range(3)]

    pre = ak.entry_prep(rows_t, [C] * L, None, D)
    assert pre.sorted_by_row
    if prep == "kernel_like":
        with pytest.raises(ValueError, match="sorted by row"):
            ak.fused_adam_multi(*state(), rows_t, g_t, 0.01, 0.3439, 0.0394, [1.0] * L,
                                pre=pre._replace(sorted_by_row=False), deterministic=True)
        return
    a, b = state(), state()
    ak.fused_adam_multi(*a, rows_t, g_t, 0.01, 0.3439, 0.0394, [1.0] * L, pre=pre,
                        deterministic=True)
    ak.fused_adam_multi(*b, rows_t, g_t, 0.01, 0.3439, 0.0394, [1.0] * L, deterministic=True)
    for x, y in zip(a, b):
        for u, w in zip(x, y):
            assert torch.equal(u, w)
