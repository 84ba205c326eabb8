"""Shared helpers of the benchmark's CPU tests: a cell run on the CPU at a
small vocab and batch (the published widths kept), the harness's look for
a card skipped. The program computes in f32 here: bf16's rounding noise in
a gradient shrinks with the root of the batch, and the limits are set for
the cells' batch of 16,384 (on the card), not for 512."""

import atexit
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

SMALL = {"vocab_size": 1000, "batch_size": 512, "compute_dtype": "float32"}
SMALL_PARAMS = {
    "train_pool": {"pool_batches": 10, "warm_superbatches": 1, "trace_superbatches": 1},
    "serve_poisson": {"rate_per_s": 100, "min_candidates": 32, "max_candidates": 512, "bodies": 16,
                      "trace_requests": 10},
    "train_tsv": {"rows": 512 * 20, "warm_logs": 2, "trace_logs": 1, "parse_batches": 2},
}


_DEFERRED = []


def root_of(cell: str) -> Path:
    """ROOT for a cell of BENCHMARK.json; for one of ``benchmark/deferred.json``
    a checkout (made once) whose BENCHMARK.json holds the deferred entries too."""
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    if any(w["name"] == cell for w in spec["workloads"]):
        return ROOT
    if not _DEFERRED:
        root = Path(tempfile.mkdtemp(prefix="bench-deferred-"))
        atexit.register(shutil.rmtree, root, True)
        (root / "benchmark").symlink_to(ROOT / "benchmark")
        deferred = json.loads((ROOT / "benchmark" / "deferred.json").read_text())
        for key in ("workloads", "end_to_end", "per_layer"):
            spec[key] += deferred[key]
        (root / "BENCHMARK.json").write_text(json.dumps(spec))
        _DEFERRED.append(root)
    return _DEFERRED[0]


def small_run(cell: str, seed: int = 7, seconds: float = 0.5, trace: bool = False, root: Path | None = None):
    """The result line of ``cell`` run once on the CPU at the small size."""
    import torch

    from benchmark import harness

    root = root_of(cell) if root is None else root
    torch.set_num_threads(4)
    kind = json.loads(harness.cell_file(root, cell).read_text())["kind"]
    params = {**json.loads(harness.cell_file(root, cell).read_text())["params"], **SMALL_PARAMS[kind]}
    run = harness.Run(cell, seed, seconds, trace, torch.device("cpu"), time.perf_counter(), root,
                      config_override=SMALL, cell_override={"params": params})
    return harness.run_cell(run)


@pytest.fixture
def run_small():
    return small_run
