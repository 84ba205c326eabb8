"""Training fed from a Criteo TSV log through ``train.loop.Trainer.run``, the
path a user runs.

Set-up writes ``rows`` lines of Criteo-format text (``gen/tsv.py``: Zipf
ranks as per-slot hex tokens, empty fields at ``cat_missing`` and
``dense_missing``) under the run's temporary directory, then runs the
Trainer on it: ``superbatch`` steps a scan and a log, no eval, no
checkpoints, its default producer; the source loops over the file. The
Trainer is given the benchmark's state (its ``engine.init`` returns it) and
a logger of the benchmark's: each log follows the Trainer's one host sync
of a superbatch, so the logger stamps the host clock there. The window
opens at log ``warm_logs`` and closes at the first log past ``seconds``
(with ``--trace 1``, after ``trace_logs`` more logs under the profiler),
where the logger ends the run.

The Trainer's first superbatch goes through the check's split (steps 1,
2-3, 4-10, each the Trainer's own scan on its own feed); the reference
works out ids and dense values again from the file's first lines.

End to end: ``fed_examples_per_s``, the examples trained between the
window's first and last log over the host-clock time between them.
"""

from __future__ import annotations

import gc
import io
import math
import os
import sys
import threading
import time

import numpy as np
import torch

from benchmark import check, port, training
from benchmark.gen import tsv, zipf
from benchmark.harness import Outcome
from benchmark.profile import Capture
from benchmark.reference import criteo


class WindowClosed(Exception):
    """Raised by the logger to end the Trainer's run."""


def make_logger(h, k: int, b: int):
    base = port.logger_base()
    p = h.params

    class WindowLogger(base):
        def __init__(self):
            super().__init__(None, stream=io.StringIO())
            self.logs = 0
            self.t0 = self.t_end = None
            self.step0 = self.steps = self.failed = 0
            self.capture = self.trace = None
            self.trace_step0 = 0

        def log_scalars(self, step, scalars, prefix="train"):
            now = time.perf_counter()
            self.logs += 1
            if self.t0 is None:
                if self.logs == p["warm_logs"]:
                    self.t0, self.step0 = h.window_started(), step
                return
            if self.t_end is None:
                if not math.isfinite(scalars["loss"]):
                    self.failed += k
                if now - self.t0 < h.seconds:
                    return
                self.t_end, self.steps = now, step - self.step0
                if not h.trace:
                    raise WindowClosed
                self.capture = Capture()
                self.trace = self.capture.__enter__()
                self.trace_step0 = step
                return
            if step - self.trace_step0 >= p["trace_logs"] * k:
                self.capture.__exit__(None, None, None)
                self.trace.steps = step - self.trace_step0
                self.trace.examples = self.trace.steps * b
                raise WindowClosed

    return WindowLogger()


def run(h) -> Outcome:
    cfg, p, dev = h.config, h.params, h.device
    b, k = cfg["batch_size"], p["superbatch"]
    path = os.path.join(h.tmpdir, "criteo.tsv")
    slots = zipf.slots_for(cfg, p, h.seed, dev)
    tsv.write(path, slots, p["rows"], cfg["n_dense"], p, h.seed, zipf.generator(h.seed, dev, 9))
    del slots
    logger = make_logger(h, k, b)
    trainer = port.trainer(port.trainer_config(cfg, path, h.seed, p["steps"], k), logger, dev)
    state = port.train_state(trainer.engine, cfg, h.seed, dev)
    trainer.engine.init = lambda seed=0, device=None: state
    probe = port.StepProbe(state, cfg, h.seed)
    scan, first = trainer.train_scan, {}

    def checked_scan(state_, dense, ids, labels):
        if first:
            return scan(state_, dense, ids, labels)
        first["losses"], m = training.first_steps(scan, state_, dense, ids, labels, probe)
        return state_, m

    trainer.train_scan = checked_scan
    before = set(threading.enumerate())
    try:
        trainer.run()
    except WindowClosed:
        pass
    for th in set(threading.enumerate()) - before:
        th.join(timeout=60)
    if logger.t_end is None:
        raise RuntimeError("the Trainer ended before the window closed: raise the cell's steps")
    e2e = {"fed_examples_per_s": logger.steps * b / (logger.t_end - logger.t0)}
    ctx = {"kind": "fed", "examples_per_s": e2e["fed_examples_per_s"], "batch_size": b}
    if h.trace:
        it = iter(port.tsv_source(cfg, path))
        next(it)
        t0 = time.perf_counter()
        for _ in range(p["parse_batches"]):
            next(it)
        ctx["parse_examples_per_s"] = p["parse_batches"] * b / (time.perf_counter() - t0)
    h.read_memory()
    prog = probe.readings(first["losses"])
    del trainer, state, probe, scan
    gc.collect()
    if getattr(dev, "type", dev) == "cuda":
        torch.cuda.empty_cache()
    dense, ids, labels = criteo.parse(criteo.read_lines(path, 3 * b), cfg["n_dense"], cfg["n_slots"],
                                      cfg["vocab_size"])
    shape = (3, b)
    ref = port.program_layout(cfg, training.reference_readings(
        cfg, h.seed, *(torch.from_numpy(np.ascontiguousarray(x)).to(dev).reshape(*shape, *x.shape[1:])
                       for x in (dense, ids, labels))))
    print(check.describe(prog, ref), file=sys.stderr)
    checks = check.judged(check.train_numbers(prog, ref), h.cell["limits"])
    return Outcome(e2e, logger.steps, logger.failed, checks, ctx, logger.trace)
