"""Phase timing, stage spans, device-memory peaks and device tracing.

Port of ``shine_mapping_tpu/utils/profiling.py``: ``PhaseTimer`` as it is
there (synchronising the card instead of a jax array), ``HbmMonitor`` over
the CUDA caching allocator's peak (``max_memory_allocated``: the tensors'
peak, not the pool the allocator reserves; zero on the CPU),
and ``device_trace`` with ``torch.profiler``.

Spans name the program's stages (``span``): the batch step's forward,
backward and update, the data phase's frame prep, wait, octree growth and
pool append, and each ``PhaseTimer`` phase.  Tracing is off unless
``tracing(True)`` (or ``device_trace``) turns it on.  Off, a span is one flag
read and a shared no-op context.  On, it records ``Span(name, tid, t0_ns,
t1_ns, parent)`` on the host's ``perf_counter_ns`` clock (``parent``: the
enclosing span's name on the same thread), and while a ``torch.profiler``
records, it also enters ``record_function(name)``: the span is then a
``user_annotation`` event of the profiler's Chrome trace, on the clock of
the kernels and launches it encloses.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict
from typing import Dict, List, NamedTuple, Optional

import torch


class Span(NamedTuple):
    name: str
    tid: int
    t0_ns: int
    t1_ns: int
    parent: Optional[str]


_ON = False
_SPANS: List[Span] = []  # appended under the GIL, from any thread
_STACKS = threading.local()


class _Off:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _On:
    __slots__ = ("name", "parent", "rf", "t0")

    def __init__(self, name: str) -> None:
        self.name = name

    def __enter__(self):
        stack = getattr(_STACKS, "names", None)
        if stack is None:
            stack = _STACKS.names = []
        self.parent = stack[-1] if stack else None
        stack.append(self.name)
        self.rf = None
        if torch.autograd._profiler_enabled():
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        _STACKS.names.pop()
        _SPANS.append(Span(self.name, threading.get_ident(), self.t0, t1, self.parent))
        return False


def span(name: str):
    """The stage ``name`` as a context manager (recorded only while tracing)."""
    return _On(name) if _ON else _OFF


def tracing(on: bool) -> bool:
    """Switch tracing on or off; returns the previous state."""
    global _ON
    was, _ON = _ON, bool(on)
    return was


def spans() -> List[Span]:
    """The spans recorded so far, in the order they ended."""
    return list(_SPANS)


def clear_spans() -> None:
    _SPANS.clear()


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

    @contextlib.contextmanager
    def phase(self, name: str, sync=None):
        """The phase ``name``, also a span of that name (the parent of the
        program's spans inside it)."""
        with span(name):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                dev = sync.device if isinstance(sync, torch.Tensor) else sync
                if dev is not None and torch.device(dev).type == "cuda":
                    torch.cuda.synchronize(dev)
                self.totals[name] += time.perf_counter() - t0

    def summary(self) -> Dict[str, float]:
        return dict(self.totals)

    def reset(self) -> None:
        self.totals.clear()


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
    Chrome trace (``trace.json``), with tracing on for the block (the spans
    are the trace's ``user_annotation`` events); no-op when ``log_dir`` is
    falsy."""
    if not log_dir:
        yield
        return
    import os

    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    was = tracing(True)
    try:
        with profile(activities=acts) as prof:
            yield
    finally:
        tracing(was)
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
