"""Profiling and tracing (port of ``recmodels_tpu/utils/profiling.py``):
``trace`` records a ``torch.profiler`` trace of the host and, where there is
one, the CUDA device into a Chrome trace file; ``annotate`` names a region of
it; ``StepTimer`` tracks step intervals without a device sync."""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def trace(logdir: str):
    """Record a trace of the block into ``<logdir>/trace.json`` (Chrome
    trace format: chrome://tracing, Perfetto) and yield the profiler, whose
    ``key_averages()`` sums the time by kernel."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def annotate(name: str):
    """Named region that shows up in the trace timeline."""
    return torch.profiler.record_function(name)


class StepTimer:
    """Wall-clock EMA of step dispatch intervals (cheap; no device sync)."""

    def __init__(self, alpha: float = 0.05):
        self.alpha = alpha
        self._last = None
        self.ema_s = None

    def tick(self) -> float | None:
        now = time.time()
        if self._last is not None:
            dt = now - self._last
            self.ema_s = dt if self.ema_s is None else (1 - self.alpha) * self.ema_s + self.alpha * dt
        self._last = now
        return self.ema_s
