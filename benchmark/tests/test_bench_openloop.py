"""The open-loop scheduler: latency from each request's due time, queueing
included, and a late loop counted apart."""

import numpy as np

from benchmark import openloop


class FakeClock:
    """A clock that moves only when told; ``sleep`` overshoots by ``oversleep``."""

    def __init__(self, oversleep=0.0):
        self.t = 100.0
        self.oversleep = oversleep

    def __call__(self):
        self.t += 1e-7  # reading it takes a little
        return self.t

    def sleep(self, s):
        self.t += s + self.oversleep


def test_latency_runs_from_the_due_time_and_counts_the_queue():
    clock = FakeClock()
    service = {0: 0.010, 1: 0.001, 2: 0.001}

    def call(r):
        clock.t += service[r]

    # request 1 is due while request 0 still runs: it waits 5 ms in the queue
    lat, svc, late, length = openloop.serve(call, [0, 1, 2], [0.0, 0.005, 0.100],
                                            clock=clock, sleep=clock.sleep)
    assert abs(lat[0] - 0.010) < 1e-5
    assert abs(lat[1] - (0.010 - 0.005 + 0.001)) < 1e-5
    assert abs(svc[1] - 0.001) < 1e-5
    assert abs(lat[2] - 0.001) < 1e-5
    assert late == 0
    assert abs(length - 0.101) < 1e-4


def test_a_late_loop_is_counted_and_its_delay_is_in_the_latency():
    clock = FakeClock(oversleep=0.004)
    lat, _, late, _ = openloop.serve(lambda r: None, [0, 1], [0.060, 0.120], clock=clock, sleep=clock.sleep,
                                     spin=0.001)
    assert late == 2
    assert all(x >= 0.004 - 0.001 - 1e-5 for x in lat)  # the oversleep past the spin


def test_poisson_arrivals_offer_every_seed_the_same_gaps():
    a = openloop.poisson_due(5000, 2000.0, np.random.default_rng(1))
    b = openloop.poisson_due(5000, 2000.0, np.random.default_rng(2))
    gaps_a, gaps_b = np.diff(np.concatenate([[0], a])), np.diff(np.concatenate([[0], b]))
    np.testing.assert_allclose(np.sort(gaps_a), np.sort(gaps_b))
    assert not np.allclose(gaps_a, gaps_b)
    assert abs(a[-1] - 5000 / 2000.0) < 0.05 * 5000 / 2000.0
    assert abs(np.std(gaps_a) / np.mean(gaps_a) - 1) < 0.1  # exponential: cv 1


def test_percentile_is_the_nearest_rank():
    v = list(range(1, 101))
    assert openloop.percentile(v, 99) == 99 and openloop.percentile(v, 50) == 50
    assert openloop.percentile([3.0], 99) == 3.0
