"""Training Wukong on multi-hot logs already on the card: DLRM-DCNv2's traffic
and replay (``train_pool_multihot.py``: a pool of batches of pooled bags made
on the device by ``gen/multihot.py``, ``Engine.jit_train_scan`` over
superbatches of ``superbatch`` steps, one host sync a superbatch), with
Wukong's door (``port_wukong.py``) and reference (``reference/wukong.py``).

Parameters and the end-to-end metric as ``train_pool_multihot``'s. The
check: the program's first three steps (``training.first_steps``, the
window's own call) against the plain reference's on the rows the three
batches touch, made again from the seed block by block, by ``check.py``'s
numbers and ``table_rows_missed`` under the cell's limits.

``table_rows_missed`` reads which rows the table's first gradient moves.
The dense leaves hold nearly all of the whole first gradient's norm, and
the table's own norm is held by the few Zipf-head rows that many examples
touch, so neither ``grad_err`` nor the table's error over its norm sees the
gradient of a batch that lost examples; but most rows a batch touches are
touched by one example alone, and a lost example leaves its rows unmoved.
A row's own error is no sharper: sound runs read a median row error of
0.14-0.40 on the card (bf16's error in one example's gradient, read back
from the row's small f32 move), fp8 from 0.50 and half a batch 1.
"""

from __future__ import annotations

import gc
import math
import sys
import time

import torch

from benchmark import check, port_multihot, port_wukong, training
from benchmark.gen import multihot as W
from benchmark.gen import zipf
from benchmark.harness import Outcome
from benchmark.profile import Capture, annotate
from benchmark.reference import wukong as reference
from benchmark.traffic.train_pool_multihot import global_ids, unique_rows


def table_rows_missed(prog: tuple, ref: tuple) -> float:
    """The rows the first gradient moves on one side alone (the reference's
    that the program left, and the program's that the reference left), over
    the rows the reference's moves; ``prog`` and ``ref`` as
    ``check.table_errors`` takes them (global row ids, rows [n, D + 1])."""
    (pi, pg), (ri, rg) = prog, ref
    dev = rg.device
    want = ri.to(dev)[rg.ne(0).any(dim=1)]
    got = pi.to(dev)[pg.to(dev).ne(0).any(dim=1)]
    both = int(torch.isin(got, want).sum())
    return (want.numel() + got.numel() - 2 * both) / max(want.numel(), 1)


def numbers(prog: dict, ref: dict) -> dict:
    """``check.train_numbers`` and ``table_rows_missed``."""
    return {**check.train_numbers(prog, ref),
            "table_rows_missed": table_rows_missed(prog["grad_table"], ref["grad_table"])}


def reference_readings(cfg: dict, seed: int, dense: torch.Tensor, ids: torch.Tensor, labels: torch.Tensor,
                       precision: str = "f32") -> dict:
    """The reference's readings of three steps from the benchmark's weights
    for ``seed`` on batches [3, B, ...] (slot-local ids), on their device;
    ``grad_table`` is (the rows' global ids, their first gradient with a
    zero first-order column), the rows the first batch touches."""
    uids, inv = torch.unique(global_ids(ids, cfg), return_inverse=True)
    rows0 = W.initial_rows(cfg, seed, uids)
    params = port_wukong.dense_weights(cfg, seed, ids.device)
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
    engine = port_wukong.build_engine(cfg)  # first: a program without the model fails at once
    slots = W.slots_for(cfg, p, h.seed, dev)
    dense, ids, labels = W.batch_pool(slots, n_pool, b, cfg["n_dense"], p, zipf.generator(h.seed, dev, 5))
    del slots
    state = port_wukong.train_state(engine, cfg, h.seed, dev)
    scan = engine.jit_train_scan()
    probe = port_wukong.StepProbe(state, cfg, h.seed)
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
    nums = numbers(prog, ref)
    print(f"{check.describe(prog, ref)}; table_rows_missed {nums['table_rows_missed']!r}", file=sys.stderr)
    checks = check.judged(nums, h.cell["limits"])
    return Outcome(e2e, steps, failed, checks, ctx, trace)
