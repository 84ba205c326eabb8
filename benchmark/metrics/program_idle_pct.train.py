"""The part of the device's idle share that the program's host path holds:
the idle gaps between device operations (kernels, copies, sets) whose
middle falls inside one of the program's ``train.*`` spans (a scan of
replays, a replay's state key, copy-in and launch), over the traced
stretch. The rest of ``device_idle_pct.train`` is the caller's."""

import bisect

from benchmark import program_trace


def read(ctx):
    t = ctx.get("trace")
    if ctx.get("kind") != "train" or t is None or not t.device_ops or t.window_s <= 0:
        return None
    merged = []
    for a, b in program_trace.spans(t, "train.", prefix=True):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    if not merged:
        return None
    starts = [a for a, _ in merged]
    busy = t.busy_intervals()
    idle = 0
    for (_, a), (b, _) in zip(busy[:-1], busy[1:]):
        mid = (a + b) // 2
        i = bisect.bisect_right(starts, mid) - 1
        if b > a and i >= 0 and mid <= merged[i][1]:
            idle += b - a
    return 100.0 * idle / 1e9 / t.window_s
