"""The harness: finds a cell's files by name, runs the cell's traffic kind once,
and assembles the result line.

Everything that belongs to one configuration, cell, traffic kind or
per-layer metric sits in a file of its own, found by its name in
``BENCHMARK.json``:

* ``benchmark/configs/<config>.json``: the configuration as it is run;
* ``benchmark/workloads/<cell>.json``: the cell's traffic kind, its
  parameters and the limits of its check;
* ``benchmark/traffic/<kind>.py``: a traffic kind, ``run(h) -> Outcome``;
* ``benchmark/metrics/<metric>.py``: a per-layer metric, ``read(ctx) ->
  float | None`` (None: nothing to read in this run; left out of the line).
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "recmodels_tpu"}


def load_spec(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell_file(root: Path, cell: str) -> Path:
    return root / "benchmark" / "workloads" / f"{cell}.json"


def traffic_file(root: Path, kind: str) -> Path:
    return root / "benchmark" / "traffic" / f"{kind}.py"


def metric_file(root: Path, metric: str) -> Path:
    return root / "benchmark" / "metrics" / f"{metric}.py"


def load_module(path: Path, name: str):
    if not path.exists():
        raise FileNotFoundError(path)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def listing(root: Path = ROOT) -> dict:
    """Every cell with its configuration, workload file and traffic kind,
    and every per-layer metric's reader, as ``BENCHMARK.json`` names them;
    raises ``FileNotFoundError`` for a file that is missing."""
    spec = load_spec(root)
    configs = {c["name"]: root / c["file"] for c in spec["configs"]}
    cells = {}
    for w in spec["workloads"]:
        cf = cell_file(root, w["name"])
        cell = json.loads(cf.read_text())
        kind = traffic_file(root, cell["kind"])
        for p in (configs[w["config"]], kind):
            if not p.exists():
                raise FileNotFoundError(p)
        cells[w["name"]] = {"config": configs[w["config"]], "workload": cf, "traffic": kind}
    metrics = {}
    for m in spec["per_layer"]:
        p = metric_file(root, m["name"])
        if not p.exists():
            raise FileNotFoundError(p)
        metrics[m["name"]] = p
    return {"cells": cells, "metrics": metrics}


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


@dataclasses.dataclass
class Outcome:
    """What a traffic kind returns: its end-to-end values by name (the
    harness adds ``setup_s``), requests or steps attempted and failed, the
    check's ``(name, value, limit)``, what the per-layer readers read, and
    the device trace of a traced run."""

    e2e: dict
    attempted: int
    failed: int
    checks: list
    ctx: dict
    trace: object = None


class Run:
    """One run of one cell: its files, its arguments and its clocks."""

    def __init__(self, cell: str, seed: int, seconds: float, trace: bool, device, t_process: float,
                 root: Path = ROOT, config_override: dict | None = None, cell_override: dict | None = None):
        self.root = Path(root)
        self.spec = load_spec(self.root)
        entries = {w["name"]: w for w in self.spec["workloads"]}
        if cell not in entries:
            raise KeyError(f"no cell {cell!r} in BENCHMARK.json")
        self.name, self.entry = cell, entries[cell]
        self.cell = {**json.loads(cell_file(self.root, cell).read_text()), **(cell_override or {})}
        self.params = self.cell["params"]
        cfg_entry = next(c for c in self.spec["configs"] if c["name"] == self.entry["config"])
        self.config = {**json.loads((self.root / cfg_entry["file"]).read_text()), **(config_override or {})}
        self.seed, self.seconds, self.trace = int(seed), float(seconds), bool(trace)
        self.device = device
        self.t_process = t_process
        self.setup_s = None
        self.memory_peak = 0
        self.tmpdir = tempfile.mkdtemp(prefix="bench-")

    def window_started(self) -> float:
        """Stamp the end of set-up; returns the host clock."""
        now = time.perf_counter()
        self.setup_s = now - self.t_process
        return now

    def read_memory(self) -> None:
        import torch

        if getattr(self.device, "type", self.device) == "cuda":
            self.memory_peak = int(torch.cuda.max_memory_allocated(self.device))

    def close(self) -> None:
        shutil.rmtree(self.tmpdir, ignore_errors=True)


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def run_cell(run: Run) -> dict:
    """Run the cell once; the result line as a dict (``checks`` last)."""
    import torch

    from benchmark import check

    kind = load_module(traffic_file(run.root, run.cell["kind"]), f"bench_traffic_{run.cell['kind']}")
    try:
        out: Outcome = kind.run(run)
    finally:
        run.close()
    spec = run.spec
    e2e = {m["name"]: m for m in spec["end_to_end"] if applies(m, run.name)}
    values = {**out.e2e, "setup_s": run.setup_s}
    cuda = getattr(run.device, "type", run.device) == "cuda"
    card = torch.cuda.get_device_name(run.device) if cuda else "cpu"
    metrics = {}
    if run.trace:
        for m in spec["per_layer"]:
            if applies(m, run.name):
                reader = load_module(metric_file(run.root, m["name"]), f"bench_metric_{m['name']}")
                v = reader.read({**out.ctx, "trace": out.trace, "config": run.config, "cell": run.name,
                                 "card": card})
                if v is not None:
                    metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        for name, m in e2e.items():
            metrics[name] = {"value": float(values[name]), "unit": m["unit"]}
    device = {"platform": "gpu" if cuda else "cpu", "kind": card,
              "count": 1, "memory_peak_bytes": run.memory_peak}
    result = {"correct": check.correct(out.checks),
              "attempted": int(out.attempted), "failed": int(out.failed),
              "metrics": metrics, "device": device}
    if run.trace and out.trace is not None:
        device["busy_s"] = out.trace.busy_s()
        device["window_s"] = out.trace.window_s
        result["breakdown"] = {"device_ops": out.trace.top_ops(), "idle_gaps": out.trace.idle_gaps()}
    result["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in out.checks}
    return result
