"""Ranking requests through ``serve.Predictor.predict_logits``, open loop.

Requests arrive as a Poisson process at ``rate_per_s`` (``openloop.py``);
one worker serves them in arrival order. A request ranks a log-uniform
number of candidates from ``min_candidates`` to ``max_candidates``: the
request bodies are ``bodies`` sizes on a fixed log-uniform grid, the same
for every seed, in an order and with contents (Zipf ids, dense features)
drawn from the seed, made on the device and handed to the program as numpy
arrays. Request i carries body ``i % bodies``.

Set-up warms every bucket the bodies use (the Predictor captures a bucket's
graph at its first request). The window serves ``rate_per_s * seconds``
requests; every answer is checked against the reference's logits.

End to end: ``serve_p99_ms``, the 99th percentile (nearest rank) of all
the window's latencies, each from the request's due time to its logits in
host memory.
"""

from __future__ import annotations

import gc
import math
import os
import sys
import time

import numpy as np
import torch

from benchmark import check, openloop, port
from benchmark.gen import weights as W
from benchmark.gen import zipf
from benchmark.harness import Outcome
from benchmark.profile import Capture, annotate
from benchmark.reference import train as ref_train


def body_sizes(p: dict, rng: np.random.Generator) -> np.ndarray:
    n = p["bodies"]
    lo, hi = math.log(p["min_candidates"]), math.log(p["max_candidates"])
    grid = np.rint(np.exp(lo + (np.arange(n) + 0.5) / n * (hi - lo))).astype(np.int64)
    return rng.permutation(grid)


def make_bodies(cfg: dict, p: dict, seed: int, dev):
    """[(dense [n, 13] f32, ids [n, 26] int32)] numpy request bodies."""
    sizes = body_sizes(p, np.random.default_rng(zipf.derive_seed(seed, 7)))
    slots = zipf.slots_for(cfg, p, seed, dev)
    dense, ids, _ = zipf.examples(slots, int(sizes.sum()), cfg["n_dense"], p, zipf.generator(seed, dev, 6))
    dense, ids = dense.cpu().numpy(), ids.cpu().numpy()
    cuts = np.cumsum(sizes)[:-1]
    return list(zip(np.split(dense, cuts), np.split(ids, cuts)))


def bucket_of(n: int, min_bucket: int = 256) -> int:
    b = min_bucket
    while b < n:
        b *= 2
    return b


def warm(pred, bodies, calls: int) -> None:
    """Each bucket the bodies use, ``calls`` times (its capture first)."""
    seen = {}
    for i, (d, _) in enumerate(bodies):
        seen.setdefault(bucket_of(d.shape[0]), i)
    for i in seen.values():
        for _ in range(calls):
            pred.predict_logits(*bodies[i])


def reference_logits(cfg: dict, seed: int, bodies, indices, dev, precision: str = "f32") -> dict:
    """{body index: the reference's logits} for ``indices``, from the
    benchmark's weights for ``seed``."""
    params = W.dense_weights(cfg, seed, dev)
    offs = torch.arange(cfg["n_slots"], device=dev) * cfg["vocab_size"]
    out = {}
    for i in sorted(set(indices)):
        dense, ids = (torch.from_numpy(x).to(dev) for x in bodies[i])
        uids, inv = torch.unique(ids.long() + offs, return_inverse=True)
        rows = W.initial_rows(cfg, seed, uids)[inv]
        out[i] = ref_train.serve_logits(cfg, params, rows, dense, precision).cpu().numpy()
    return out


def reference_gap(cfg: dict, seed: int, bodies, served, dev) -> float:
    """The largest |logit - reference logit| over every served answer;
    ``served``: (body index, logits) pairs."""
    served = list(served)
    want = reference_logits(cfg, seed, bodies, [bi for bi, _ in served], dev)
    gap = 0.0
    for bi, z in served:
        if z.shape != want[bi].shape or not np.all(np.isfinite(z)):
            return float("inf")
        gap = max(gap, float(np.max(np.abs(z.astype(np.float64) - want[bi]))))
    return gap


class Answers:
    """Every answer of a stretch in one preallocated buffer: request j's
    logits at ``buf[start[j]:start[j] + n_j]``."""

    def __init__(self, order, bodies):
        sizes = np.array([bodies[i][0].shape[0] for i in order], np.int64)
        self.order, self.start = order, np.concatenate([[0], np.cumsum(sizes)])
        self.buf = np.full(int(self.start[-1]), np.nan, np.float32)

    def pairs(self):
        return ((bi, self.buf[self.start[j]:self.start[j + 1]]) for j, bi in enumerate(self.order))


def serve_program(rate: float, seconds: float, bodies, pred, rng: np.random.Generator):
    """Run the open loop at ``rate`` for ``seconds``; (answers, latencies,
    service times, late wake-ups, loop length)."""
    n = max(1, round(rate * seconds))
    due = openloop.poisson_due(n, rate, rng)
    order = [i % len(bodies) for i in range(n)]
    answers = Answers(order, bodies)
    slots = iter(range(n))

    def call(i):
        j = next(slots)
        with annotate("bench.predict_logits"):
            z = pred.predict_logits(*bodies[i])
        if z.shape == (answers.start[j + 1] - answers.start[j],):
            answers.buf[answers.start[j]:answers.start[j + 1]] = z

    gc.collect()
    pauses = GcPauses()
    with annotate("bench.open_loop"), pauses:
        lat, svc, late, length = openloop.serve(call, order, due)
    print(f"open loop: {pauses}", file=sys.stderr)
    return answers, lat, svc, late, length


class GcPauses:
    """The collector's pauses in a stretch, by generation (for stderr)."""

    def __init__(self):
        self.by_gen = {0: [], 1: [], 2: []}

    def _cb(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        else:
            self.by_gen[info["generation"]].append(time.perf_counter() - self._t)

    def __enter__(self):
        gc.callbacks.append(self._cb)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self._cb)

    def __str__(self):
        return "; ".join(f"gen {g}: {len(v)} collections, {sum(v) * 1e3:.3f} ms, max {max(v, default=0) * 1e3:.3f} ms"
                         for g, v in self.by_gen.items())


def pin_worker(dev) -> None:
    """Keep the worker (this thread) on two of the card's own cores, so
    that a run does not wander across the host's cores while it spins."""
    if getattr(dev, "type", dev) != "cuda" or not hasattr(os, "sched_setaffinity"):
        return
    prop = torch.cuda.get_device_properties(dev)
    bus = f"{prop.pci_domain_id:04x}:{prop.pci_bus_id:02x}:{prop.pci_device_id:02x}.0"
    try:
        with open(f"/sys/bus/pci/devices/{bus}/local_cpulist") as f:
            text = f.read().strip()
    except OSError:
        return
    cores = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        cores.extend(range(int(lo), int(hi or lo) + 1))
    usable = sorted(set(cores) & os.sched_getaffinity(0))
    if len(usable) >= 2:
        os.sched_setaffinity(0, usable[:2])


def run(h) -> Outcome:
    cfg, p, dev = h.config, h.params, h.device
    pin_worker(dev)
    bodies = make_bodies(cfg, p, h.seed, dev)
    engine = port.build_engine(cfg)
    state = port.serve_state(engine, cfg, h.seed, dev)
    pred = port.predictor(engine, state, dev)
    warm(pred, bodies, p["warm_calls"])
    rng = np.random.default_rng(zipf.derive_seed(h.seed, 8))
    h.window_started()
    answers, lat, svc, late, length = serve_program(p["rate_per_s"], h.seconds, bodies, pred, rng)
    failed = sum(1 for _, z in answers.pairs() if not np.all(np.isfinite(z)))
    e2e = {"serve_p99_ms": openloop.percentile(lat, 99) * 1e3}
    print(f"open loop: {len(lat)} requests in {length:.3f} s, latency max {max(lat) * 1e3:.3f} ms, "
          f"{sum(x > 0.01 for x in lat)} over 10 ms, {late} late wake-ups", file=sys.stderr)
    ctx = {"kind": "serve", "serve_call_ms": [s * 1e3 for s in svc], "late_wakeups": late,
           "window_s": length, "requests": len(lat)}
    trace = None
    if h.trace:
        n_trace = p["trace_requests"]
        with Capture() as trace:
            more = serve_program(p["rate_per_s"], n_trace / p["rate_per_s"], bodies, pred, rng)
        trace.requests = len(more[1])
    h.read_memory()
    del pred, state, engine
    gc.collect()
    if getattr(dev, "type", dev) == "cuda":
        torch.cuda.empty_cache()
    served = list(answers.pairs()) + (list(more[0].pairs()) if h.trace else [])
    gap = reference_gap(cfg, h.seed, bodies, served, dev)
    checks = check.judged({"logit_gap": gap}, h.cell["limits"])
    return Outcome(e2e, len(lat), failed, checks, ctx, trace)
