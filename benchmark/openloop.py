"""An open loop of requests served by one worker, in arrival order.

Request i is due ``due[i]`` seconds after the loop starts, whatever became
of the requests before it: arrivals do not wait for the server. The one
worker takes each request when it is due, or, when it is still busy, as
soon as it is free; a request's latency runs from its due time to its
answer, so time spent queued behind a slow request counts. When the worker
was idle and woke up more than ``late_after`` seconds past a due time, the
loop itself ran late: that is counted, apart from the latencies.

Arrivals are a Poisson process at a fixed rate: gaps that are the
exponential law's quantiles at ``(i + 1/2) / n``, in an order drawn from
the seed, so that every seed offers the same gaps and the same load.
"""

from __future__ import annotations

import math
import time

import numpy as np


def poisson_due(n: int, rate: float, rng: np.random.Generator) -> np.ndarray:
    """Due times (s) of ``n`` arrivals at ``rate`` per second."""
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n) / rate
    return np.cumsum(rng.permutation(gaps))


def wait_until(t: float, clock=time.perf_counter, sleep=time.sleep, spin: float = 0.05) -> None:
    """Sleep until ``spin`` seconds before ``t``, then spin to it: a wait
    shorter than ``spin`` never sleeps, so the loop does not wait on the
    host's scheduler to wake it and the worker's core stays awake."""
    ahead = t - clock() - spin
    if ahead > 0:
        sleep(ahead)
    while clock() < t:
        pass


def serve(call, requests, due, clock=time.perf_counter, sleep=time.sleep, late_after: float = 1e-3,
          spin: float = 0.05):
    """Serve ``requests`` in order with ``call`` (which keeps its answers
    itself: the loop holds no Python object a request, so the collector has
    no more to walk as the window goes on), request i due ``due[i]`` seconds
    after the start. Returns (latencies s, service times s, late wake-ups,
    the loop's length s from its start to the last answer)."""
    start = clock()
    latency, service = [], []
    late = 0
    for r, d in zip(requests, due):
        t_due = start + float(d)
        if clock() < t_due:
            wait_until(t_due, clock, sleep, spin)
            if clock() - t_due > late_after:
                late += 1
        t_call = clock()
        call(r)
        done = clock()
        latency.append(done - t_due)
        service.append(done - t_call)
    return latency, service, late, clock() - start


def percentile(values, q: float) -> float:
    """The nearest-rank ``q`` percentile (0-100)."""
    s = sorted(values)
    return s[max(0, math.ceil(q / 100.0 * len(s)) - 1)]
