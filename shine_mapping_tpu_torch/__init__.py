"""PyTorch / CUDA port of the SHINE mapping framework (``shine_mapping_tpu``).

A second package beside the JAX one, with every module of it under the same
name: sparse hierarchical feature grids stored as per-level hash tables, a
shallow MLP SDF decoder, BCE-on-sdf training from LiDAR or RGB-D ray samples
(every update mode and loss term, continual learning), the batch and
incremental drivers on one card or over several ranks (one process or
several launched apart), marching meshing, offline evaluation, the
visualizer's offscreen snapshots and the RGB-D converter.  The TPU's Pallas
kernels are hand-written CUDA (and Triton) kernels for Hopper (``csrc/``).
It imports neither ``jax`` nor ``shine_mapping_tpu``.  Entry points run on
``cuda`` unless the config or the caller says ``cpu``; on the CPU every
kernel wrapper runs its plain torch version.

Quick start (library):

    from shine_mapping_tpu_torch import SHINEConfig
    from shine_mapping_tpu_torch.cli.shine_batch import run_shine_mapping_batch
    cfg = SHINEConfig().load("config/maicity/maicity_batch.yaml")
    run_path, grid, params = run_shine_mapping_batch(cfg=cfg)

or from the command line:

    python -m shine_mapping_tpu_torch.cli.shine_batch config/maicity/maicity_batch.yaml
"""

from .config import SHINEConfig

__version__ = "0.1.0"
__all__ = [
    "SHINEConfig",
    "Mesher",
    "HashGridHost",
    "LiDARDataset",
    "MapVisualizer",
    "__version__",
]


def __getattr__(name):  # lazy heavy imports
    if name == "Mesher":
        from .mesher import Mesher

        return Mesher
    if name == "HashGridHost":
        from .ops.hashgrid import HashGridHost

        return HashGridHost
    if name == "LiDARDataset":
        from .data.dataset import LiDARDataset

        return LiDARDataset
    if name == "MapVisualizer":
        from .visualizer import MapVisualizer

        return MapVisualizer
    raise AttributeError(name)
