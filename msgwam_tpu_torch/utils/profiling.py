"""Profiling hooks: step timing and ``torch.profiler`` trace capture, the
counterparts of :mod:`msgwam_tpu.utils.profiling`."""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch


def _devices(tree):
    if isinstance(tree, torch.Tensor):
        yield tree.device
    elif isinstance(tree, (tuple, list)):
        for x in tree:
            yield from _devices(x)


class StepTimer:
    """Wall-clock timer that waits for the device results it is given, so
    the measured time includes the device's work (a warm-up call can be
    dropped with :meth:`reset`)."""

    def __init__(self):
        self.times = []
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, result=None):
        """Record the time since :meth:`start`, after every CUDA device that
        holds a tensor of ``result`` (a tensor or a tree of them) has
        finished its queued work."""
        for dev in {d for d in _devices(result) if d.type == "cuda"}:
            torch.cuda.synchronize(dev)
        self.times.append(time.perf_counter() - self._t0)

    def reset(self):
        self.times = []

    @property
    def mean(self):
        return sum(self.times) / max(1, len(self.times))

    @property
    def best(self):
        return min(self.times) if self.times else float("nan")


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """Capture a ``torch.profiler`` trace (host, and the card where there
    is one) around a block and write it to ``log_dir/trace.json`` in the
    Chrome trace format; a no-op without ``log_dir``.  Yields the profiler
    (``None`` without ``log_dir``)."""
    if log_dir is None:
        yield None
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
