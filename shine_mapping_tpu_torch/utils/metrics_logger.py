"""Metrics logging: JSONL always, wandb when available and enabled.

The port's copy of ``shine_mapping_tpu/utils/metrics_logger.py``.

Replaces the reference's wandb-only logging (utils/tools.py:43-47,120-133;
shine_batch.py:215-226) with a dependency-free JSONL stream per run plus an
optional wandb mirror.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional


class MetricsLogger:
    def __init__(self, run_path: str, wandb_on: bool = False, project: str = "SHINEMappingTPU", run_name: str = ""):
        self.path = os.path.join(run_path, "metrics.jsonl")
        self._f = open(self.path, "a", buffering=1)
        self._wandb = None
        if wandb_on:
            try:
                import wandb

                wandb.init(project=project, dir=run_path)
                if run_name:
                    wandb.run.name = run_name
                self._wandb = wandb
            except Exception as e:  # wandb genuinely optional
                print(f"wandb unavailable ({e}); JSONL logging only")

    def log(self, data: Dict[str, Any]) -> None:
        rec = {"t": time.time()}
        for k, v in data.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = v
        self._f.write(json.dumps(rec) + "\n")
        if self._wandb is not None:
            self._wandb.log(data)

    def close(self) -> None:
        self._f.close()
        if self._wandb is not None:
            self._wandb.finish()
