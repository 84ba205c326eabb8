"""The device trace of a traced run: ``torch.profiler`` over a steady stretch,
read in memory (no trace file), reduced to device operations, the busy
union, the idle gaps and what the host was doing in them.

Device operations are the profiler's events on the CUDA device: kernels,
copies and sets. ``layer_of`` names a kernel's layer by the harness's map
(``kernel_map.json``), so a rewrite of the program cannot change which
kernel a roofline divides by: a kernel of the program's own (a
``__global__`` function of its ``csrc``) that the map does not name is
``unmapped``, and shows in the breakdown.
"""

from __future__ import annotations

import functools
import json
import re
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch

KERNEL_MAP = json.loads((Path(__file__).resolve().parent / "kernel_map.json").read_text())
_OWN = {name: layer for layer, names in KERNEL_MAP["own"].items() for name in names}
CSRC = Path(__file__).resolve().parents[1] / "recmodels_tpu_torch" / "csrc"
_GLOBAL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?(\w+)\s*\(")


@functools.lru_cache(maxsize=None)
def program_kernels(csrc: Path = CSRC) -> frozenset:
    """The names of the program's own kernels: its sources' ``__global__``
    functions."""
    names = set()
    for path in sorted(csrc.glob("*.cu*")):
        names.update(_GLOBAL.findall(path.read_text()))
    return frozenset(names)


def short_name(name: str) -> str:
    """A kernel's name without ``void``, arguments, template arguments or
    anonymous namespaces: ``rm::cin2_fwd_kernel``, ``at::native::...``."""
    n = name.replace("(anonymous namespace)::", "")
    if n.startswith("void "):
        n = n[5:]
    n = n.split("(")[0]
    depth, out = 0, []
    for c in n:
        if c == "<":
            depth += 1
        elif c == ">":
            depth -= 1
        elif depth == 0:
            out.append(c)
    return "".join(out).strip()


def layer_of(name: str) -> str:
    """``gather``, ``emb_update``, ``cin_fwd``, ... for the port's kernels
    the map names, ``unmapped`` for its others; ``library`` for
    cuBLAS/cuBLASLt/CUTLASS; ``copy`` for copies and sets; ``glue`` for the
    rest."""
    if name.startswith(("Memcpy", "Memset")):
        return "copy"
    parts = short_name(name).split("::")
    if "::".join(parts[:-1]) in KERNEL_MAP["own_namespaces"]:
        if parts[-1] in _OWN:
            return _OWN[parts[-1]]
        if parts[-1] in program_kernels():
            return "unmapped"
    low = name.lower()
    if any(p.lower() in low for p in KERNEL_MAP["library_patterns"]):
        return "library"
    return "glue"


@dataclass
class Trace:
    """Device operations (name, start ns, duration ns), host events (name,
    start ns, duration ns), the stretch's host-clock seconds and what ran in
    it (steps, requests, examples)."""

    device_ops: list = field(default_factory=list)
    host_events: list = field(default_factory=list)
    window_s: float = 0.0
    steps: int = 0
    requests: int = 0
    examples: int = 0

    def kernels(self):
        return [op for op in self.device_ops if not op[0].startswith(("Memcpy", "Memset"))]

    def busy_intervals(self):
        merged = []
        for start, stop in sorted((s, s + d) for _, s, d in self.device_ops):
            if merged and start <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], stop)
            else:
                merged.append([start, stop])
        return merged

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e9

    def layer_ms(self, layer: str) -> float:
        return sum(d for n, _, d in self.device_ops if layer_of(n) == layer) / 1e6

    def top_ops(self, n: int = 10):
        """The ``n`` device operations that took most time, each named
        ``<layer>: <kernel>``; where the program ran kernels the map does not
        name and none is among them, the last entry is their sum."""
        by = {}
        for name, _, d in self.device_ops:
            k = f"{layer_of(name)}: {short_name(name)[:120] or name[:120]}"
            by[k] = by.get(k, 0) + d
        top = sorted(by.items(), key=lambda kv: -kv[1])
        unmapped = [(k, v) for k, v in top if k.startswith("unmapped: ")]
        top = top[:n]
        if unmapped and not any(k.startswith("unmapped: ") for k, _ in top):
            names = ", ".join(k[len("unmapped: "):] for k, _ in unmapped)
            top[-1] = (f"unmapped: {names}"[:200], sum(v for _, v in unmapped))
        return [[k, v / 1e9] for k, v in top]

    def idle_gaps(self, n: int = 10):
        """The idle time between device operations, summed by the innermost
        host event that covered each gap's middle, largest first."""
        busy = self.busy_intervals()
        gaps = [(a, b) for (_, a), (b, _) in zip(busy[:-1], busy[1:]) if b > a]
        host = sorted(self.host_events, key=lambda e: e[1])
        by, active, i = {}, [], 0
        for a, b in gaps:  # in time order; ``active``: host events open at the gap's middle
            mid = (a + b) // 2
            while i < len(host) and host[i][1] <= mid:
                active.append(host[i])
                i += 1
            active = [e for e in active if e[1] + e[2] >= mid]
            label = min(active, key=lambda e: e[2])[0] if active else "none"
            by[label] = by.get(label, 0) + (b - a)
        return [[k, v / 1e9] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


class Capture:
    """``with Capture() as t: ...`` profiles the block and fills ``t``. The
    block's own code ends in a device sync (its last step's readback)."""

    def __init__(self):
        self.trace = Trace()

    def __enter__(self) -> Trace:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._t0 = time.perf_counter()
        return self.trace

    def __exit__(self, *exc):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.trace.window_s = time.perf_counter() - self._t0
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self._read()
        return False

    def _read(self) -> None:
        for e in self._prof.profiler.kineto_results.events():
            name, start, dur = e.name(), e.start_ns(), e.duration_ns()
            if str(e.device_type()).endswith("CUDA"):
                # a host span's shadow on the device timeline is no operation
                if not name.startswith("bench.") and not getattr(e, "is_user_annotation", lambda: False)():
                    self.trace.device_ops.append((name, start, dur))
            else:
                self.trace.host_events.append((name, start, dur))


def annotate(name: str):
    """A host span that labels the idle gaps it covers."""
    return torch.profiler.record_function(name)
