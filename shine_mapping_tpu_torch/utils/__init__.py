from . import experiment, checkpoint, metrics_logger

__all__ = ["experiment", "checkpoint", "metrics_logger"]
