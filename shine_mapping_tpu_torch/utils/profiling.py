"""Phase timing, device-memory peaks and device tracing.

Port of ``shine_mapping_tpu/utils/profiling.py``: ``PhaseTimer`` as it is
there (synchronising the card instead of a jax array), ``HbmMonitor`` over
the CUDA caching allocator's peak (``max_memory_allocated``: the tensors'
peak, not the pool the allocator reserves; zero on the CPU),
and ``device_trace`` with ``torch.profiler``.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Optional

import torch


class PhaseTimer:
    """Accumulates wall time per named phase; ``sync``: a device (or a tensor
    on one) whose queued work ends the phase.

    Usage:
        timer = PhaseTimer()
        with timer.phase("load"):
            batch = ...
        with timer.phase("train", sync=loss):
            ...
        timer.summary()  # {'load': 0.01, 'train': 1.2}
    """

    def __init__(self) -> None:
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, sync=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dev = sync.device if isinstance(sync, torch.Tensor) else sync
            if dev is not None and torch.device(dev).type == "cuda":
                torch.cuda.synchronize(dev)
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> Dict[str, float]:
        return dict(self.totals)

    def means(self) -> Dict[str, float]:
        return {k: v / max(self.counts[k], 1) for k, v in self.totals.items()}

    def reset(self) -> None:
        self.totals.clear()
        self.counts.clear()


class HbmMonitor:
    """Peak device memory by phase across a driver run.

    Drivers call :meth:`sample` at the end of each phase (upload,
    precompute, each training chunk, mesh): it records the allocator's peak
    since the previous sample under the tag, then resets the peak, so each
    tag holds its own phase's high-water mark.  On a CPU device every
    reading is 0."""

    def __init__(self, device="cuda") -> None:
        self.device = torch.device(device)
        self.peak_live = 0
        self.samples: Dict[str, int] = {}
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)

    def sample(self, tag: str = "") -> int:
        b = 0
        if self.device.type == "cuda":
            b = torch.cuda.max_memory_allocated(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
        self.peak_live = max(self.peak_live, b)
        if tag:
            self.samples[tag] = max(self.samples.get(tag, 0), b)
        return b

    def report(self) -> Dict[str, object]:
        return {
            "peak_live_bytes": int(self.peak_live),
            "peak_live_gb": round(self.peak_live / 2**30, 3),
            "samples_gb": {k: round(v / 2**30, 3) for k, v in self.samples.items()},
        }


# the most recent driver run's monitor (read after an in-process run)
last_hbm_monitor: Optional[HbmMonitor] = None


@contextlib.contextmanager
def device_trace(log_dir: Optional[str]):
    """``torch.profiler`` trace of the block, written to ``log_dir`` as a
    Chrome trace (``trace.json``); no-op when ``log_dir`` is falsy."""
    if not log_dir:
        yield
        return
    import os

    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
