"""The readers of the program's own tracing: its spans in a traced run's host
events, its set-up counters and its step's phase samples, each read from a
hand-built ``Trace`` and snapshot; nothing is reported where the program
left no span, counter or sample, or has no ``snapshot`` at all."""

import sys
import types

import pytest

from benchmark import harness, profile

from conftest import ROOT

PHASES = {"gather_ms_per_step.train": "step.gather", "forward_ms_per_step.train": "step.forward",
          "backward_ms_per_step.train": "step.backward", "dense_opt_ms_per_step.train": "step.dense_opt",
          "sparse_update_ms_per_step.train": "step.sparse_update"}
SETUP = {"setup_capture_s": "graph.capture_s", "setup_kernels_s": "kernels.load_s"}
KERNEL = "void at::native::vectorized_elementwise_kernel<4>(int)"


def read(name, ctx):
    return harness.load_module(harness.metric_file(ROOT, name), f"t_{name}").read(ctx)


@pytest.fixture
def program(monkeypatch):
    """Replace the program's ``snapshot`` by one that returns the dict the
    test fills."""
    from recmodels_tpu_torch.utils import profiling

    snap = {"counters": {}, "phases": {}}
    monkeypatch.setattr(profiling, "snapshot", lambda: snap)
    return snap


@pytest.fixture
def no_snapshot(monkeypatch):
    """A program whose profiling module has no ``snapshot`` (an older one)."""
    monkeypatch.setitem(sys.modules, "recmodels_tpu_torch.utils.profiling", types.ModuleType("profiling"))


def train_ctx(trace):
    return {"kind": "train", "trace": trace}


def test_host_ms_per_step_is_the_mean_train_step_span():
    host = [("train.scan", 0, 10_000_000), ("train.step", 100, 200_000), ("train.step.key", 150, 10_000),
            ("train.step", 1_000_000, 400_000), ("bench.sync", 9_000_000, 1_000)]
    assert read("host_ms_per_step.train", train_ctx(profile.Trace(host_events=host))) == pytest.approx(0.3)
    assert read("host_ms_per_step.train", train_ctx(profile.Trace(host_events=host[-1:]))) is None
    assert read("host_ms_per_step.train", {"kind": "serve", "trace": profile.Trace(host_events=host)}) is None
    assert read("host_ms_per_step.train", {"kind": "train"}) is None


def test_program_idle_counts_the_gaps_whose_middle_is_in_a_train_span():
    # device busy 0-100, 200-300, 400-500, 900-1000 ns; gaps 100-200, 300-400, 500-900
    ops = [(KERNEL, a, 100) for a in (0, 200, 400, 900)]
    host = [("train.scan", 120, 250),  # holds the middles 150 and 350 (its child nested inside)
            ("train.step.copy_in", 140, 20),
            ("trainer.wait", 500, 400),  # the caller's: "trainer." is no "train." span
            ("bench.sync", 600, 10)]
    t = profile.Trace(device_ops=ops, host_events=host, window_s=1e-6)
    assert read("program_idle_pct.train", train_ctx(t)) == pytest.approx(100.0 * 200 / 1000)
    device_idle = read("device_idle_pct.train", train_ctx(t))
    assert device_idle == pytest.approx(100.0 * 600 / 1000)
    assert read("program_idle_pct.train", train_ctx(t)) <= device_idle
    no_spans = profile.Trace(device_ops=ops, host_events=host[2:], window_s=1e-6)
    assert read("program_idle_pct.train", train_ctx(no_spans)) is None
    assert read("program_idle_pct.train", train_ctx(profile.Trace(host_events=host, window_s=1e-6))) is None


@pytest.mark.parametrize("name", sorted(PHASES))
def test_each_phase_reads_the_median_of_its_samples(program, name):
    program["phases"] = {PHASES[name]: [3.0, 1.0, 2.0, 10.0], "step.other": [99.0]}
    assert read(name, train_ctx(profile.Trace())) == 2.5
    assert read(name, {"kind": "train"}) is None  # no traced run
    program["phases"] = {}
    assert read(name, train_ctx(profile.Trace())) is None


@pytest.mark.parametrize("name", sorted(PHASES) + sorted(SETUP))
def test_nothing_is_read_from_a_program_without_snapshot(no_snapshot, name):
    assert read(name, train_ctx(profile.Trace())) is None


@pytest.mark.parametrize("name", sorted(SETUP))
def test_setup_splits_read_the_programs_counters(program, name):
    assert read(name, train_ctx(profile.Trace())) is None
    program["counters"] = {SETUP[name]: 1.25, "kernels.built": 1}
    assert read(name, train_ctx(profile.Trace())) == 1.25


def test_the_readers_read_a_cpu_run_of_the_program():
    """The program's spans through a real CPU run of a cell: the step's host
    span is read; a CPU run captures no graph and times no phase, so those
    report nothing."""
    from conftest import small_run

    cell = "deepfm-criteo.train-zipf"
    metrics = small_run(cell, seconds=0.2, trace=True)["metrics"]
    assert metrics["host_ms_per_step.train"]["value"] > 0
    for name in list(PHASES) + ["setup_capture_s", "program_idle_pct.train"]:
        assert name not in metrics
