"""How far float rounding carries the port's training from one device to the
other, by loss term: the card against the CPU (plain versions) and the card
against itself, from the same weights on the same batches.

Runs chip_smoke.py phase 5's small sphere world (feature_update: pallas,
adam_eps 1e-3) for 1, 5 and 20 steps with the consistency term, without
extra terms, with the eikonal term, and with the dense autodiff update,
and prints per level the largest |d p| (absolute and as a share of the
table's largest value) and the share of elements past rtol 1e-4, atol
1e-5.  Needs a CUDA card:

    python scripts/consistency_spread.py
"""

import copy
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402
from shine_mapping_tpu_torch.config import SHINEConfig  # noqa: E402
from shine_mapping_tpu_torch.ops.hashgrid import HashGridHost  # noqa: E402
from shine_mapping_tpu_torch.train import trainer  # noqa: E402
from shine_mapping_tpu_torch.train.optimizer import init_opt_state  # noqa: E402

CASES = (("consistency", dict(consistency_loss_on=True)), ("plain", {}),
         ("eikonal", dict(ekional_loss_on=True)), ("dense", dict(feature_update="dense")))


def run(device, over, steps, init, draws, pool, surf, cfg):
    grid = HashGridHost(7, 3, 8, 0.05, seed=3, init_node_capacity=1 << 12,
                        init_corner_capacity=1 << 12, device=device)
    grid.update(surf)
    s = trainer.TrainSettings.from_config(
        cfg, grid.levels, sigma_sigmoid=0.05,
        **dict(dict(feature_update="pallas", n_used=trainer.used_rows_for(grid)), **over))
    params = trainer.init_params(cfg, grid)
    for k in ("geo", "sem"):
        params[k].load_state_dict(init[k])
    dev, nv = trainer.pool_to_device(pool, len(pool), device=device, settings=s)
    params, _, aux = trainer.train_chunk(params, init_opt_state(params), grid.tables, dev, nv,
                                         0, None, s, steps,
                                         **{k: v[:steps] for k, v in draws.items()})
    return [f.cpu().float() for f in params["features"]], float(aux["mean"]["total_loss"])


def spread(x, y):
    out = []
    for u, v in zip(x, y):
        d = float((u - v).abs().max())
        past = float((~torch.isclose(u, v, rtol=1e-4, atol=1e-5)).float().mean())
        out.append(f"max|d| {d:.2e} ({d / float(v.abs().max()):.2e} of scale), "
                   f"past rtol 1e-4 {past:.5f}")
    return "; ".join(out)


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    print(torch.cuda.get_device_name(0))
    for label, over in CASES:
        pool, surf = chip_smoke._option_world(())
        cfg = SHINEConfig()
        cfg.tree_level_world, cfg.tree_level_feat, cfg.bs, cfg.lr = 7, 3, 1024, 0.01
        cfg.adam_eps = 1e-3
        cfg.derive()
        rng = np.random.default_rng(7)
        draws = {"batch_indices": torch.from_numpy(rng.integers(0, len(pool), (20, cfg.bs)))}
        if over.get("consistency_loss_on"):
            cnt, r = min(cfg.consistency_count, cfg.bs), cfg.consistency_range * cfg.scale
            draws["near_indices"] = torch.from_numpy(rng.integers(0, cfg.bs, (20, cnt)))
            draws["near_shifts"] = torch.from_numpy(
                rng.uniform(-r, r, (20, cnt, 3)).astype(np.float32))
        p0 = trainer.init_params(cfg, HashGridHost(7, 3, 8, 0.05, seed=3, device="cpu"),
                                 torch.Generator().manual_seed(0))
        init = {k: copy.deepcopy(p0[k].state_dict()) for k in ("geo", "sem")}
        for steps in (1, 5, 20):
            cpu, lc = run("cpu", over, steps, init, draws, pool, surf, cfg)
            a, la = run("cuda", over, steps, init, draws, pool, surf, cfg)
            b, lb = run("cuda", over, steps, init, draws, pool, surf, cfg)
            print(f"{label} {steps} steps: loss cpu {lc:.7f} card {la:.7f} {lb:.7f}")
            print(f"   card vs cpu: {spread(a, cpu)}")
            print(f"   card vs card: {spread(a, b)}")


if __name__ == "__main__":
    main()
