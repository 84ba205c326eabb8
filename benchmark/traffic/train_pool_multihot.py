"""Training on multi-hot logs already on the card (DLRM-DCNv2): a pool of
batches of pooled bags made on the device (``gen/multihot.py``), replayed
through ``Engine.jit_train_scan`` in superbatches of ``superbatch`` steps,
one host sync a superbatch, as ``train_pool`` replays one-hot batches.

Parameters (the cell's file): ``pool_batches`` (a multiple of
``superbatch``), ``superbatch``, ``warm_superbatches``,
``trace_superbatches``, the first ids' ``zipf_exponent`` and ``zipf.py``'s
``dense_*`` and ``label_rate``. The configuration gives the slots' rows
(``num_embeddings_per_feature``) and bags (``hotness``).

End to end: ``train_examples_per_s``, the examples of every superbatch the
window ran over the window's host-clock time, from a sync to a sync.

The check: the program's first three steps (``training.first_steps``, the
window's own call) against the plain reference's (``reference/dlrm_dcnv2.py``)
on the rows the three batches touch, made again from the seed block by
block, by ``check.py``'s numbers under the cell's limits.
"""

from __future__ import annotations

import gc
import math
import sys
import time

import torch

from benchmark import check, port_multihot, training
from benchmark.gen import multihot as W
from benchmark.gen import zipf
from benchmark.harness import Outcome
from benchmark.profile import Capture, annotate
from benchmark.reference import dlrm_dcnv2 as reference


def global_ids(ids: torch.Tensor, cfg: dict) -> torch.Tensor:
    """Global row ids (int64) of slot-local ids [..., n_ids]."""
    off = W.slot_offsets(cfg)
    col = torch.tensor([off[s] for s, h in enumerate(cfg["hotness"]) for _ in range(h)], device=ids.device)
    return ids.long() + col


def unique_rows(ids: torch.Tensor, cfg: dict) -> int:
    """Distinct table rows of one batch [B, n_ids] of slot-local ids."""
    return int(torch.unique(global_ids(ids, cfg)).numel())


def reference_readings(cfg: dict, seed: int, dense: torch.Tensor, ids: torch.Tensor, labels: torch.Tensor,
                       precision: str = "f32") -> dict:
    """The reference's readings of three steps from the benchmark's weights
    for ``seed`` on batches [3, B, ...] (slot-local ids), on their device;
    ``grad_table`` is (the rows' global ids, their first gradient with a
    zero first-order column), the rows the first batch touches (the others'
    first gradient is 0)."""
    uids, inv = torch.unique(global_ids(ids, cfg), return_inverse=True)
    rows0 = W.initial_rows(cfg, seed, uids)
    params = W.dense_weights(cfg, seed, ids.device)
    out = reference.readings(cfg, params, rows0, inv, dense.float(), labels.float(), precision)
    del rows0
    first = torch.unique(inv[0])
    out["grad_table"] = (uids[first], port_multihot.with_wide(out["grad_table"][first]))
    return out


def run(h) -> Outcome:
    cfg, p, dev = h.config, h.params, h.device
    b, k, n_pool = cfg["batch_size"], p["superbatch"], p["pool_batches"]
    if n_pool % k or n_pool < k:
        raise ValueError("pool_batches must be a multiple of superbatch")
    slots = W.slots_for(cfg, p, h.seed, dev)
    dense, ids, labels = W.batch_pool(slots, n_pool, b, cfg["n_dense"], p, zipf.generator(h.seed, dev, 5))
    del slots
    engine = port_multihot.build_engine(cfg)
    state = port_multihot.train_state(engine, cfg, h.seed, dev)
    scan = engine.jit_train_scan()
    probe = port_multihot.StepProbe(state, cfg, h.seed)
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
           "ids_per_step": b * sum(cfg["hotness"]), "bags_per_step": b * cfg["n_slots"]}
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
        ctx["unique_rows_per_step"] = sum(unique_rows(ids[i], cfg) for i in batches) / len(batches)
    h.read_memory()
    first3 = tuple(t[:3].clone() for t in (dense, ids, labels))
    prog = probe.readings(first_losses)
    del scan, state, engine, probe, dense, ids, labels
    gc.collect()
    if getattr(dev, "type", dev) == "cuda":
        torch.cuda.empty_cache()
    ref = reference_readings(cfg, h.seed, *first3)
    print(check.describe(prog, ref), file=sys.stderr)
    checks = check.judged(check.train_numbers(prog, ref), h.cell["limits"])
    return Outcome(e2e, steps, failed, checks, ctx, trace)
