"""Tracing of the port (port of ``recmodels_tpu/utils/profiling.py``).

* ``trace`` records a ``torch.profiler`` trace of the host and, where there
  is one, the CUDA device into a Chrome trace file (the Trainer's
  ``profile_dir``).
* ``annotate(name)`` is the one span primitive: a ``record_function`` while
  a ``torch.profiler`` session is active, else one shared no-op context, so
  a span costs one flag check with tracing off.
* ``count(name, value)`` adds to a host-side counter. Only code that runs
  while a step is traced or captured calls it (the kernel library's load,
  graph captures, the CIN's padded fused route), never once a replay.
* ``phase(name)`` marks a phase of the training step. In an eager step under
  a profiler it is a span. Inside a timed capture (``timed_capture``, the
  timed twin of a step's graph, ``train/capture.py``) it records a pair of
  CUDA timing events into the graph, which the twin's replays record on the
  device. ``replay_timed`` replays a twin and reads the previous twin
  replay's events, only if the device has passed them: it never waits.
* ``snapshot()`` returns the counters and the phase samples (device ms of
  each phase, one sample a read replay), reading a last pending replay.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

_NULL = contextlib.nullcontext()
_counters: dict[str, float] = {}
_samples: dict[str, list[float]] = {}  # phase -> device ms of each read replay
_marks: list | None = None  # the timed capture in progress: (phase, start event, end event)
_pending: list | None = None  # the marks of the last timed replay, not read yet


@contextlib.contextmanager
def trace(logdir: str):
    """Record a trace of the block into ``<logdir>/trace.json`` (Chrome
    trace format: chrome://tracing, Perfetto) and yield the profiler, whose
    ``key_averages()`` sums the time by kernel. Every thread's spans are
    recorded (the Trainer's producer thread too), not only this one's."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    every_thread = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    with torch.profiler.profile(activities=activities, experimental_config=every_thread) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def tracing() -> bool:
    """Whether a ``torch.profiler`` session is active."""
    return torch.autograd.profiler._is_profiler_enabled


def annotate(name: str):
    """A named span of the trace timeline while a profiler is active; the
    shared no-op context otherwise."""
    if torch.autograd.profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _NULL


def count(name: str, value: float) -> None:
    """Add ``value`` to the counter ``name``."""
    _counters[name] = _counters.get(name, 0) + value


@contextlib.contextmanager
def timed(name: str):
    """Time the block as counter ``name`` (seconds, host clock), added."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        count(name, time.perf_counter() - t0)


def phase(name: str):
    """A phase of the training step: timing events inside a timed capture,
    else a span (``annotate``)."""
    if _marks is not None:
        return _timed_phase(name)
    return annotate(name)


@contextlib.contextmanager
def _timed_phase(name: str):
    start = torch.cuda.Event(enable_timing=True, external=True)
    end = torch.cuda.Event(enable_timing=True, external=True)
    start.record()
    yield
    end.record()
    _marks.append((name, start, end))


@contextlib.contextmanager
def timed_capture():
    """Within the block, ``phase`` records timing events into the capture
    in progress; yields the list of (phase, start event, end event) it
    fills."""
    global _marks
    _marks = marks = []
    try:
        yield marks
    finally:
        _marks = None


def replay_timed(graph, marks: list) -> None:
    """Replay ``graph``, the timed twin whose capture filled ``marks``; read
    the previous timed replay's events first if the device has passed them
    (the replay records them again), and leave this one's pending."""
    global _pending
    _read_pending(wait=False)
    graph.replay()
    _pending = marks


def _read_pending(wait: bool) -> None:
    global _pending
    marks, _pending = _pending, None
    if not marks:
        return
    if wait:
        marks[-1][2].synchronize()
    elif not marks[-1][2].query():
        return
    by_phase: dict[str, float] = {}
    for name, start, end in marks:  # a phase marked several times a step is summed
        by_phase[name] = by_phase.get(name, 0.0) + start.elapsed_time(end)
    for name, ms in by_phase.items():
        _samples.setdefault(name, []).append(ms)


def snapshot() -> dict:
    """{'counters': {name: value}, 'phases': {phase: [device ms a read
    replay]}}, copies; reads the last timed replay first (waiting for it)."""
    _read_pending(wait=True)
    return {"counters": dict(_counters), "phases": {k: list(v) for k, v in _samples.items()}}
