"""What the program's own tracing holds, for the per-layer readers: its spans
among a traced run's host events (``Trace.host_events``), and its set-up
counters and the device time of its training step's phases by
``recmodels_tpu_torch.utils.profiling.snapshot()``. A program without that
tracing gives nothing to read, and its readers report nothing."""

from __future__ import annotations

import statistics


def snapshot() -> dict | None:
    """The program's counters and phase samples; None where it has none."""
    try:
        from recmodels_tpu_torch.utils.profiling import snapshot as program_snapshot
    except ImportError:
        return None
    return program_snapshot()


def counter(name: str) -> float | None:
    snap = snapshot()
    return None if snap is None else snap["counters"].get(name)


def phase_ms(ctx: dict, name: str) -> float | None:
    """The median device ms of the training step's phase ``name`` over the
    samples the traced stretch left (about one a superbatch)."""
    if ctx.get("kind") != "train" or ctx.get("trace") is None:
        return None
    snap = snapshot()
    samples = None if snap is None else snap["phases"].get(name)
    return statistics.median(samples) if samples else None


def spans(trace, name: str, prefix: bool = False) -> list:
    """(start ns, end ns) of the host events named ``name`` (``prefix``:
    whose names start with it), in start order."""
    return sorted((s, s + d) for n, s, d in trace.host_events
                  if (n.startswith(name) if prefix else n == name))
