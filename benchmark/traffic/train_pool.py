"""Training on logs already on the card: a pool of Zipf batches made on the
device, replayed through ``Engine.jit_train_scan`` in superbatches of
``superbatch`` steps, one host sync a superbatch (the Trainer's log).

Parameters (the cell's file): ``pool_batches`` (a multiple of
``superbatch``, so each superbatch is one slice of the pool and the window
copies nothing of its own), ``superbatch``, ``warm_superbatches``,
``trace_superbatches``, and the generator's ``zipf_exponent``,
``dense_*``, ``label_rate``.

End to end: ``train_examples_per_s``, the examples of every superbatch the
window ran over the window's host-clock time, from a sync to a sync.
"""

from __future__ import annotations

import gc
import math
import sys
import time

import torch

from benchmark import check, port, training
from benchmark.gen import zipf
from benchmark.harness import Outcome
from benchmark.profile import Capture, annotate


def run(h) -> Outcome:
    cfg, p, dev = h.config, h.params, h.device
    b, k, n_pool = cfg["batch_size"], p["superbatch"], p["pool_batches"]
    if n_pool % k or n_pool < k:
        raise ValueError("pool_batches must be a multiple of superbatch")
    slots = zipf.slots_for(cfg, p, h.seed, dev)
    dense, ids, labels = zipf.batch_pool(slots, n_pool, b, cfg["n_dense"], p, zipf.generator(h.seed, dev, 5))
    del slots
    engine = port.build_engine(cfg)
    state = port.train_state(engine, cfg, h.seed, dev)
    scan = engine.jit_train_scan()
    probe = port.StepProbe(state, cfg, h.seed)
    first_losses, _ = training.first_steps(scan, state, dense[:k], ids[:k], labels[:k], probe)

    def superbatch(j: int) -> float:
        s = (j * k) % n_pool
        _, m = scan(state, dense[s:s + k], ids[s:s + k], labels[s:s + k])
        with annotate("bench.sync"):
            return float(m["losses"].sum())  # the superbatch's one sync

    j = 1
    for _ in range(p["warm_superbatches"]):
        superbatch(j)
        j += 1
    t0 = h.window_started()
    steps = failed = 0
    while True:
        total = superbatch(j)
        j += 1
        steps += k
        failed += 0 if math.isfinite(total) else k
        now = time.perf_counter()
        if now - t0 >= h.seconds:
            break
    e2e = {"train_examples_per_s": steps * b / (now - t0)}
    ctx = {"kind": "train", "examples_per_s": e2e["train_examples_per_s"], "batch_size": b,
           "ids_per_step": b * cfg["n_slots"]}
    trace = None
    if h.trace:
        first = j
        with Capture() as trace:
            for _ in range(p["trace_superbatches"]):
                superbatch(j)
                j += 1
        trace.steps = p["trace_superbatches"] * k
        trace.examples = trace.steps * b
        batches = [(jj * k) % n_pool + i for jj in range(first, j) for i in range(k)]
        ctx["unique_rows_per_step"] = sum(training.unique_rows(ids[i], cfg) for i in batches) / len(batches)
    h.read_memory()
    first3 = tuple(t[:3].clone() for t in (dense, ids, labels))
    prog = probe.readings(first_losses)
    del scan, state, engine, probe, dense, ids, labels
    gc.collect()
    if getattr(dev, "type", dev) == "cuda":
        torch.cuda.empty_cache()
    ref = port.program_layout(cfg, training.reference_readings(cfg, h.seed, *first3))
    print(check.describe(prog, ref), file=sys.stderr)
    checks = check.judged(check.train_numbers(prog, ref), h.cell["limits"])
    return Outcome(e2e, steps, failed, checks, ctx, trace)
