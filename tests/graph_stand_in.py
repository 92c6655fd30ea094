"""A stand-in for ``train_chunk``'s recorded iid step on the CPU, which has
no CUDA graphs; the port's trainer and span tests import its fixture."""

import pytest

from shine_mapping_tpu_torch.train import trainer
from shine_mapping_tpu_torch.utils import profiling


@pytest.fixture
def stand_in_graph(monkeypatch):
    """``trainer.step_graph_ok`` answers for CPU tensors as for CUDA ones,
    and the recording keeps the step's body, which each replay runs
    untraced (a replay records no stage spans).  Resets
    ``trainer.GRAPH_COUNTS``."""
    ok = trainer.step_graph_ok
    monkeypatch.setattr(trainer, "step_graph_ok", lambda s, device, *a: ok(s, "cuda", *a))

    def record(body):
        def replay():
            was = profiling.tracing(False)
            try:
                body()
            finally:
                profiling.tracing(was)
        return replay

    monkeypatch.setattr(trainer, "_record_graph", record)
    trainer.reset_graph_counts()
