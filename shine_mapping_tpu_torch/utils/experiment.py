"""Experiment setup: run directories, seeding, timing.

Port of ``shine_mapping_tpu/utils/experiment.py`` (reference
``setup_experiment``, utils/tools.py:23-54): a timestamped run directory
with mesh/map/model subfolders and a copy of the config, plus a timer that
synchronises the card first (utils/tools.py:232-237).
"""

from __future__ import annotations

import os
import shutil
import time
from datetime import datetime

import numpy as np
import torch


def setup_experiment(config, config_file: str | None = None) -> str:
    ts = datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
    run_path = os.path.join(config.output_root or ".", f"{config.name}_{ts}")
    for sub in ("", "mesh", "map", "model"):
        os.makedirs(os.path.join(run_path, sub), mode=0o755, exist_ok=True)
    if config_file and os.path.exists(config_file):
        shutil.copy2(config_file, run_path)
    np.random.seed(config.seed)
    return run_path


def get_time(device=None) -> float:
    """Wall time after the queued work of ``device`` (a CUDA device) has
    run; host time alone for the CPU or None."""
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    return time.time()
