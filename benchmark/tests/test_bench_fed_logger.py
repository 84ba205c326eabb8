"""The fed cell's logger opens the window at its warm-up log and ends the
Trainer's run at the first log past the window (after the traced logs,
when traced)."""

import time

import pytest

from benchmark.traffic import train_tsv


class FakeRun:
    def __init__(self, seconds, trace):
        self.seconds, self.trace = seconds, trace
        self.params = {"warm_logs": 2, "trace_logs": 2}
        self.started = None

    def window_started(self):
        self.started = time.perf_counter()
        return self.started


def drive(h, logger, k=10, gap=0.03, limit=100):
    for n in range(1, limit):
        time.sleep(gap)
        logger.log_scalars(n * k, {"loss": 0.5})
    raise AssertionError("the logger never ended the run")


def test_the_window_closes_at_the_first_log_past_its_end():
    h = FakeRun(seconds=0.2, trace=False)
    logger = train_tsv.make_logger(h, 10, 512)
    with pytest.raises(train_tsv.WindowClosed):
        drive(h, logger)
    assert logger.t0 == h.started and logger.step0 == 20  # opened at log 2
    length = logger.t_end - logger.t0
    assert 0.2 <= length < 0.2 + 0.03 * 3
    assert logger.steps == (logger.logs - 2) * 10


def test_a_traced_run_profiles_its_logs_after_the_window():
    h = FakeRun(seconds=0.1, trace=True)
    logger = train_tsv.make_logger(h, 10, 512)
    with pytest.raises(train_tsv.WindowClosed):
        drive(h, logger)
    assert logger.trace is not None and logger.trace.steps == 20 and logger.trace.examples == 20 * 512
    assert logger.trace.window_s > 0.05


def test_a_non_finite_loss_counts_its_steps_failed():
    h = FakeRun(seconds=0.1, trace=False)
    logger = train_tsv.make_logger(h, 10, 512)
    logger.log_scalars(10, {"loss": 1.0})
    logger.log_scalars(20, {"loss": 1.0})
    logger.log_scalars(30, {"loss": float("nan")})
    assert logger.failed == 10
