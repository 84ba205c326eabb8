#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving, training and eval paths on one
NVIDIA GPU and check them.

    python3 chip_smoke.py            # from the repository root, one card

Phases, each on its own lines:
  1. card:     the card's name and power limit, as nvidia-smi reports them;
  2. build:    the kernels of recmodels_tpu_torch/csrc/, built into
               recmodels_tpu_torch/_build/ (reused when the sources are unchanged);
  3. kernels:  each kernel against its plain PyTorch version on the card at the
               flagship shapes (xDeepFM: B = 16,384, 26 slots of 1e5 ids, dim
               16, CIN(128,128)): the gather, the fanout and the CIN forward of
               serving, the fanout and CIN backward and the sparse Adagrad
               update of training (on the 2,600,960 x 17 table and on a dim-1
               table of as many rows), both fanouts also in f32 (the f32
               xDeepFM path's [16384, 26, 17] rows); its time, the plain
               version's, a single PyTorch call's where one computes the
               same function, and its
               bound (the larger of bytes over the memory rate and operations
               over the peak rate, from the H100 SXM data sheet); then the
               kernels of the slice-3 path: lazy Adam (on a 2,600,960 x 16
               table and on a dim-1 table, bit-exact), one generic CIN layer
               forward (layer-1 and layer-2 shapes, bf16 and f32) and
               backward (layer-2 shape), and the field-matrix transpose;
               then those of slice 4: the FM term on the stride-17 view of
               gathered rows (DeepFM's [16384, 26, 16] bf16, FM's [8192, 26,
               16] f32) and the DCN cross stack (x0 [16384, 429], 3 layers,
               bf16 and f32, each with a SHA-256 of its output's bytes); the
               gather also at each other instance the paths launch (f32
               rows, slice 3's 16-column and 1-column tables, 33-column rows
               of dim 32, requests of 26 and 26,000 ids, LR's one-column f32
               rows), the sparse Adagrad update also on PNN's 16-column table
               and with LR's f32 grads on the dim-1 table. A kernel shorter than about 0.1 ms (the gather,
               both fanouts, the updates, the transpose, the FM term,
               the cross stack), its plain version and its library call are
               timed with a cold L2 and, by torch.profiler, warm; the rest
               by CUDA events over back-to-back calls (the CIN layer also
               by torch.profiler; the fused CIN forward and backward, the
               bf16 layer forward and the layer backward also launch by
               launch, by torch.profiler; the layer backward beside the JAX
               package's einsum backward); the gather and the updates also
               print sector_bound_ms, the distinct 32-byte sectors of device
               memory their inputs and outputs touch over the memory rate;
  4. serving:  full-width bf16 xDeepFM (26 x 1e5 ids, dim 16, CIN(128,128),
               DNN(400,400)) initialised from a seed (with weights under which
               each kernel's output moves the logits), exported, loaded with
               load_predictor(device="cuda") and asked requests of 1, 1,000 and
               16,384 examples (padded to the buckets 256, 1,024 and 16,384,
               each a CUDA graph captured at its first request); every
               serving kernel must have launched, the logits must be finite,
               match eager Engine.logits on each unpadded request and the
               same artifact served on the CPU by the plain path; each
               bucket's eager and captured events per request; throughput at
               16,384;
  5. training: the same model trained with Engine.train_step at 16,384
               (dense Adam lr 1e-3, sparse Adagrad lr 1e-2) for 30 steps of the
               synthetic stream; every kernel of the step must have launched,
               the loss must be finite and fall; then eval of the trained
               state: 10 batches of 16,384 from a stream no phase trains on
               (the training task) and a tail batch of 10,000 kept rows (a
               0/1 weight), through Engine.eval_step and jit_eval_step (their
               AUC states bit for bit equal; the histograms and count equal
               to the CPU's auc_update on the card's logits, the loss sum
               within 1e-5; the AUC within 1e-4 of the exact rank AUC; eager
               and captured ms per batch); one step from live weights
               at 1,024 examples must match the CPU plain path's step (loss,
               Adam moments, which hold the dense grads, the touched rows of
               the table and acc, untouched rows bit for bit); the step's device time,
               examples/s and profile; then the captured step: 30 steps
               through Engine.jit_train_step (an eager warm-up, the capture,
               replays) in lockstep with 30 eager steps from one start state
               on the same batches (whether the bits agree, and every loss and
               the final state within the one-step check's tolerances), one
               jit_train_scan of 30 steps (its losses bit for bit the stepwise
               captured run's), and the captured step's events per step over
               10 back-to-back calls beside the eager events and kernel time,
               with a profile of replays;
  6. training, slice 3: bf16 xDeepFM with CIN(128,128,128), the wide column
               in its own dim-1 table (fuse_wide=False) and lazy Adam on both
               tables (lr 1e-2), 30 steps at 16,384: the gather, the transpose,
               the CIN layer forward and backward and the Adam update must
               launch on every step, the loss must be finite and fall; one step
               from live weights at 1,024 examples must match the CPU plain
               path's step (loss, dense Adam moments, each table's m and v on
               touched rows; the table moves by the Adam step of its own
               moments, bit for bit; untouched rows bit for bit); the step's
               event time, kernel time, busy share, launches and profile (the
               two tables share one sort of their ids); the captured step as
               in 5 (no scan); then one dense-Adam
               ("adam_dense") table update on the card, run twice from one
               state (identical bits) and held against the CPU;
  7. slice 4, for each of full-width bf16 DeepFM (DNN(400,400,400)), bf16
               DCN (3 cross layers over x0 of 429, DNN(512,256)) and f32 FM
               (26 x 1e5 ids, dim 16, the engine's defaults: dense Adam lr
               1e-3, sparse Adagrad lr 1e-2): serving as in 4 (requests of
               1, 1,000 and the batch, 16,384 or FM's 8,192; the FM term, or
               the cross layers' own share (x_L - x0) . w_out, must move the
               logits), then training as in 5, 30 steps at the same batch, and
               its captured step (no scan); then f32 xDeepFM (bench.py --no-bf16: CIN(128,128),
               DNN(400,400), the engine's defaults, batch 16,384) the same
               way: its CIN runs through the layer kernel, which must
               launch exactly twice a training step;
  8. repaired shapes (ROADMAP queue 3), served and trained one step at
               1,024 examples against the CPU plain path: bf16 xDeepFM at dim
               32 and with CIN(256,256) (the fused CIN kernels), with
               CIN(100,100) (layer by layer), and bf16 DCN at dim 40 (x0 of
               1,053: the cross stack's wide-row path); each must launch the
               kernels its route names and no others;
  9. slice 6, for each of full-width f32 LR (the dim-1 wide table alone:
               the gather at one f32 column, the dim-1 update), bf16 PNN
               (inner and outer products, DNN(400,400), a 16-column table),
               bf16 Wide&Deep (DNN(256,128)), bf16 NFM (DNN(128,128)) and bf16
               AFM (attention 32), at 16,384 (bench.py:37-47, the engine's
               defaults): serving as in 4 (the first-order sum and the
               model's interaction term must each move the logits), training
               as in 5 (the gather and the sparse update on every step) and
               its captured step (no scan);
 10. slice 7, the training entry point, on the flagship at full width through
     the port's CLIs and Trainer:
     (g) the loop: ``cli.train`` for 60 steps in superbatches of 10, a
         cosine schedule with 10 warmup steps, adamw decay 1e-4, eval of 4
         held-out batches at step 60, checkpoints every 20, the producer
         pool at its default size and a profiler trace of superbatches 2-4:
         every kernel of the step launches inside the Trainer, the last
         logged loss is below the first, val AUC and logloss are finite,
         checkpoints 20, 40 and 60 exist; the loop's examples/s per log
         interval, then a 200-step run without checkpoints, eval or trace
         (its sustained examples/s) and the producer pool alone, beside
         (c') of the same configuration; the card's busy share over the
         trace, and the ms to save and restore one full-width checkpoint;
     (h) resume: 40 steps straight, and 20 steps then a resume to 40 by a
         new run (constant lr, decay, checkpoints every 10): the two final
         checkpoints equal bit for bit;
     (i) compiled steps: ``jit_train_step_accum`` (two micro-batches of
         8,192) 10 steps and a 30-step cosine-with-warmup ``jit_train_step``
         run, each in lockstep with its eager step, bit for bit after every
         step; the accumulated step's captured ms;
     (j) ``cli.export`` of checkpoint 60 and ``cli.predict`` of two synthetic
         batches with the artifact, against sigmoid(Engine.logits) of the
         restored checkpoint; 4 steps on the Criteo sample through the native
         parser and its 96 rows scored;
     (k) slice 8, in-graph data generation on the flagship: the batch kernel
         (csrc/device_synth.cu) against its plain version at 16,384, steps 0,
         1 and 2^31 - 1 (raw draws and ids bit for bit, dense within one ulp,
         labels apart only within 1e-6 of their probability), timed cold and
         warm beside the plain version and its bound (bytes, and the integer
         operations over the INT32 rate); 10 captured generated steps
         (``jit_train_scan_gen``) bit for bit 10 eager ``train_scan_gen``
         steps, and their ms a step beside (c'); ``cli.train --data
         device_synth`` for 200 steps (every kernel of the step and the batch
         kernel launch inside it), its sustained examples/s beside (c') and the
         host-fed loop's (g), and a traced run's busy share; resume (40
         straight, 20 + 20) bit for bit; captured eval on the generated
         held-out stream bit for bit eager;
     (l) slice 9, the sharded path (``parallel/``) in an NCCL process group
         of one rank: full-width bf16 xDeepFM through
         ``build_parallel_engine`` (capacity factor 1.25) and the local
         engine from one global start state (``shard_state``), 30 steps
         side by side, every loss and the final state bit for bit, the
         overflow 0 and #1-#6 launched on every sharded step;
         ``build_parallel_steps``' captured steps (NCCL's collectives in
         the graph) over 30 steps and ``build_parallel_scan`` over 10, bit
         for bit eager; its eval of 4 held-out batches, the AUC state the
         local ``jit_eval_step``'s; ``gather_with_stats`` at a capacity
         factor of 0.05 against the CPU's plain sharded engine (a gloo
         group beside the NCCL one): the same overflow count, overflowed
         rows zero, the rest the local gather's; the sharded (c') beside
         the local one, their kernels by part and the exchange's stages;
         the owner's #1 and #4 at its 532,480 positions; then the slice-3
         configuration (lazy Adam on both tables) 5 steps bit for bit the
         local engine's, #7 twice a step;
     (m) slice 10, several processes: ``multihost.initialize`` forms the
         NCCL world of one that phases l and m run in; the flagship trained
         10 captured steps on the local engine and checkpointed, restored by
         ``restore_cross_geometry`` into the world-1 sharded engine (state
         and logits bit for bit the local ones), 10 eager sharded steps from
         there (#1-#6 on each), saved through ``gather_state`` (the stall:
         the gather and the host copy, beside the local save's), restored
         into the local engine (the gathered state bit for bit) and
         exported from the sharded state (byte for byte the local
         restore's artifact); then at vocab 700 a slot a checkpoint of a
         world of 4's padded rows (20,480) restored into the world-1
         sharded engine (18,432) and back to local, bit for bit;
     (n) ``graft_entry_torch``: ``entry()``'s forward on the card against
         the CPU's plain path, and ``dryrun_multichip(1)`` (one rank in an
         NCCL world of its own, a process of its own);
     (o) the pooled bag gather and #4 at d = 128 on a batch of the
         benchmark's DLRM-DCNv2 cell (``bag_gather_phase``): each bit for bit
         its plain version, timed beside the plain version,
         ``embedding_bag(mode="sum")`` and their byte bounds;
 11. a JSON line listing the kernels (launches from the run of each kernel's
     path; phase l's sharded paths and phase m's restored one last), then
     the card line again, then the result line {"ok": true, "device": {...}}.

Any failed check raises, so the script exits non-zero before the result line.
It also exits non-zero when no CUDA device is present, and when it stands
alone, without the package beside it.
"""

from __future__ import annotations

import faulthandler
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM data sheet, dense: device memory rate, bf16 tensor-core rate and
# the f32 rate outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOP_PER_S = 989e12
PEAK_F32_FLOP_PER_S = 67e12
# 32-bit integer operations: the data sheet's f32 rate is 2 (an FMA) x 128
# FP32 lanes an SM x 132 SMs x 1.98 GHz; an SM has half as many INT32
# lanes, an operation each
PEAK_INT32_OP_PER_S = PEAK_F32_FLOP_PER_S / 4

BATCH = 16_384
VOCAB = 100_000
DIM = 16
CIN = (128, 128)
CIN3 = (128, 128, 128)
HIDDEN = (400, 400)
# slice 4, bench.py:39-54: DeepFM DNN(400,400,400); DCN 3 cross layers and
# DNN(512,256); FM in f32 at its own batch
DEEPFM_HIDDEN = (400, 400, 400)
DCN_HIDDEN = (512, 256)
N_CROSS = 3
FM_BATCH = 8192
# slice 6, bench.py:37-47: PNN mode both, DNN(400,400); Wide&Deep
# DNN(256,128); NFM DNN(128,128); AFM attention 32; LR none; all at 16,384
PNN_HIDDEN = (400, 400)
WIDEDEEP_HIDDEN = (256, 128)
NFM_HIDDEN = (128, 128)
AFM_ATTENTION = 32
# eval on the flagship: batches of a stream no phase trains on, with the
# training task_seed (SyntheticSource's default, 0), and a tail batch of
# which EVAL_TAIL rows count
EVAL_BATCHES = 10
EVAL_SEED = 37
EVAL_TAIL = 10_000
# histogram AUC against the exact rank AUC (train/metrics.py: O(1/K))
AUC_TOL = 1e-4
# the eval loss sum on the card against the CPU's on the card's logits: f32
# sums of 173,840 values in another order, exp rounded apart by an ulp
LOSS_SUM_RTOL = 1e-5
SEED = 0
# slice 7, the training entry point (phases g-j): the flagship through the
# CLIs and the port's Trainer. The loop: LOOP_STEPS steps in superbatches of
# LOOP_SCAN, a cosine schedule with LOOP_WARMUP warmup steps, adamw decay
# LOOP_DECAY, eval of LOOP_EVAL_BATCHES at the end, checkpoints every
# LOOP_CKPT_EVERY; the resume drill RESUME_STEPS straight against half and a
# resume; the compiled steps ACCUM_STEPS accumulated steps of two
# micro-batches and SCHED_STEPS scheduled ones
LOOP_STEPS = 60
LOOP_SCAN = 10
LOOP_WARMUP = 10
LOOP_DECAY = 1e-4
LOOP_EVAL_BATCHES = 4
LOOP_CKPT_EVERY = 20
RESUME_STEPS = 40
# the sustained loop: enough superbatches past the producer's prefetch (2)
# that the later intervals show the rate at which batches are made
SUSTAIN_STEPS = 200
SUSTAIN_FROM = 60
ACCUM_STEPS = 10
SCHED_STEPS = 30
# slice 8, in-graph data generation (phase k): the batch kernel at these
# steps; GEN_STEPS captured generated steps against eager ones; a traced run
# of GEN_TRACE_STEPS; GEN_EVAL_BATCHES generated held-out batches
SYNTH_STEPS = (0, 1, 2**31 - 1)
SYNTH_LABEL_MARGIN = 1e-6
GEN_STEPS = 10
GEN_TRACE_STEPS = 60
GEN_EVAL_BATCHES = 4
# the batch kernel's counts (csrc/device_synth.cu): examples a block; the
# integer operations of a draw (threefry2x32: 2 + 20 rounds of 3 + 5
# injections of 3; the XOR, shift and OR of the float) and of an id's bucket
# weight (the hash's multiply-add, 3 xor-shifts, 2 multiplies, the shift);
# the key draws a block (fold_in and split for 4 threads)
SYNTH_ROWS = 64
INT_OPS_PER_DRAW = 80
INT_OPS_PER_ID = 11
SYNTH_KEY_DRAWS = 8
FIXTURE = os.path.join("tests", "fixtures", "criteo_sample.tsv")
FIXTURE_BATCH = 32
# each of phases g-j takes under a minute; one still running after this many
# seconds is hung: every thread's stack is printed and the script exits
PHASE_LIMIT_S = 300
# slice 9, the sharded path (phase l): SHARDED_STEPS steps in lockstep with
# the local engine and as captured steps, a scan of SHARDED_SCAN,
# SHARDED_EVAL_BATCHES held-out batches, SHARDED3_STEPS lazy-Adam steps; the
# capacity factor of the run and of the overflow check
SHARDED_STEPS = 30
SHARDED_SCAN = 10
SHARDED_EVAL_BATCHES = 4
SHARDED3_STEPS = 5
SHARDED_CAPACITY = 1.25
OVERFLOW_CAPACITY = 0.05
# slice 10, several processes (phase m): the local flagship's steps before its
# checkpoint and the sharded steps after the restore; the geometry change at
# vocab 700 a slot (alloc 18,432 rows: a world of 4 pads to 20,480, while at
# world 1 no vocab changes the tables' shape) at a batch of 1,024
RESTORE_STEPS = 10
SHARDED_RESUME_STEPS = 10
GEOMETRY_VOCAB = 700
GEOMETRY_WORLD = 4
GEOMETRY_BATCH = 1024
# kernel vs plain on bf16 outputs: both sum in f32 in different orders and then
# round to bf16, so a value may land one bf16 step (2^-8 relative) apart; p2
# sums 3,328 such inputs. 1% of the largest magnitude covers that, and a
# wrong index or a missed term is far larger.
BF16_REL_TOL = 1e-2
# GPU serving vs CPU serving of one artifact: the same formulas on both sides,
# bf16 rounding flips from summation order through CIN and MLP
LOGIT_REL_TOL = 1e-2
# each kernel-made term (wide_sum, p1 . w_cin, p2 . w_cin) must move some
# logit by at least this many logit tolerances, so that the GPU-vs-CPU
# comparison would see that term go wrong
TERM_MIN_TOLS = 10.0
# f32 sums of 26 values in another order: a few f32 ulps
F32_REL_TOL = 1e-5
# DCN cross stack, kernel vs plain in bf16, per element as a share of
# dcn_cross_stack_scale: a t that rounds one bf16 step (2^-8 of itself)
# apart moves x0 * t by that, and the next layer's t by that times x0 . w
# (about N(0, 1)); eight steps leave room for |x0 . w| up to about 6 and a
# flip in each elementwise rounding (the kernel-order check below is exact)
DCN_BF16_REL_TOL = 2.0 ** -5
TRAIN_STEPS = 30
TRAIN_CHECK_BATCH = 1024
# the shapes of ROADMAP queue 3 run at a small batch over a small vocab: the
# kernels see the model's widths, the CPU's step stays short
REPAIR_BATCH = 1024
REPAIR_VOCAB = 10_000
# GPU step vs CPU step from one state: the grads pass through the same bf16
# rounding points; a rounding that lands one bf16 step apart in the CIN or
# the MLP moves a grad by about 2^-8 of its size. 3% of the largest change
# of each tensor, or part of the table (the repo's bf16 rule,
# tests/test_tpu_kernels.py), bounds it.
STEP_REL_TOL = 0.03
# f32 CIN layer, kernel vs plain: the same f32 sums (Hk * m terms) in another
# order; TF32 is off on both sides
F32_LAYER_REL_TOL = 1e-4
# dense Adam, card vs CPU: the duplicate sums in the same stream order, the
# f32 square root correctly rounded on the card and within an ulp on the
# CPU: a few f32 ulps of each change
DENSE_ADAM_REL_TOL = 1e-5


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def profile(fn, calls: int = 3, top: int = 12) -> tuple[float, float, int]:
    """Print the device time per call of the kernels ``fn`` runs, from
    torch.profiler, and the share of the window the device was busy; return
    the kernels' time per call (ms), that share and the kernel launches per
    call."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    fn()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        if not str(e.device_type).endswith("CUDA"):
            continue  # host-side ops: their device time is their kernels'
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = e.self_cuda_time_total
        rows.append((dev_us / 1e3 / calls, e.count // calls, e.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows) * calls
    print(f"profile: device busy {busy:.4f} ms of a {wall_ms:.4f} ms window "
          f"({busy / wall_ms:.1%}), {calls} calls")
    for ms, count, name in rows[:top]:
        print(f"profile: {ms:.4f} ms/call x{count} {name[:90]}")
    launches = sum(r[1] for r in rows)
    print(f"profile: {launches} kernel launches per call")
    return busy / calls, busy / wall_ms, launches


def cold_ms(fn, iters: int = 20) -> float:
    """Mean device time of ``fn`` with a cold L2, for kernels shorter than
    the host's time to launch them (where CUDA events over back-to-back
    calls measure the host). Before each call the card writes a 2 GiB
    buffer: that evicts the 50 MB L2 and keeps the card busy (about 0.7 ms)
    while the host queues the call, so the events around it time its
    kernels alone."""
    flush = torch.empty(2**29, dtype=torch.float32, device="cuda")
    fn()
    torch.cuda.synchronize()
    pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
             for _ in range(iters)]
    for start, end in pairs:
        flush.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(start.elapsed_time(end) for start, end in pairs) / iters


def launch_split(fn, calls: int = 20, tries: int = 3, full_names: bool = False) -> dict[str, float]:
    """Device time per call of each kernel ``fn`` launches, by name, from
    torch.profiler over back-to-back calls (with the L2 as the previous call
    left it; a kernel launched twice a call counts both). Names are cut to
    the function's own unless ``full_names`` (a templated PyTorch kernel's
    arguments garble the cut). Empty if in ``tries`` windows the profiler
    recorded no kernel of the card."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        split = {}
        for e in prof.key_averages():
            if str(e.device_type).endswith("CUDA"):
                dev_us = getattr(e, "self_device_time_total", None)
                dev_us = e.self_cuda_time_total if dev_us is None else dev_us
                name = e.key
                if not full_names:
                    name = name.replace("(anonymous namespace)::", "").replace("void ", "").split("(")[0]
                    name = name.split("::")[-1]
                split[name] = split.get(name, 0.0) + dev_us / 1e3 / calls
        if sum(split.values()) > 0:
            return split
        print("launch_split: the profiler recorded no kernel of the card in this window")
    return {}


def device_ms(fn, calls: int = 20) -> float | None:
    """Device time per call of the kernels ``fn`` launches (``launch_split``
    summed); None (not measured) if the profiler recorded none."""
    split = launch_split(fn, calls)
    return sum(split.values()) if split else None


def short_times(kernel, plain, library=None, prefix: str = "") -> dict:
    """Timing keys of a kernel row for a kernel shorter than about 0.1 ms,
    where CUDA events over back-to-back calls measure the host's launch
    time: ``ms``, ``plain_ms`` and ``library_ms`` with a cold L2
    (``cold_ms``), ``warm_ms``, ``plain_warm_ms`` and ``library_warm_ms``
    by torch.profiler over back-to-back calls, and ``event_ms`` by CUDA
    events, each key after ``prefix``."""
    times = {"ms": cold_ms(kernel), "warm_ms": device_ms(kernel), "event_ms": time_ms(kernel),
             "plain_ms": cold_ms(plain), "plain_warm_ms": device_ms(plain),
             "library_ms": None if library is None else cold_ms(library),
             "library_warm_ms": None if library is None else device_ms(library)}
    return {prefix + k: v for k, v in times.items()}


SHORT_TIMING = ("ms, plain_ms, library_ms: cold L2 (cold_ms); warm_ms, plain_warm_ms, library_warm_ms: "
                "back-to-back calls by torch.profiler; event_ms: back-to-back calls by CUDA events")


def bound_ms(nbytes: float, flops: float = 0.0,
             peak_flop_per_s: float = PEAK_BF16_FLOP_PER_S) -> tuple[float, str]:
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / peak_flop_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def range_sectors(t: torch.Tensor) -> int:
    """32-byte sectors of device memory that all of contiguous ``t`` spans."""
    if t.numel() == 0:
        return 0
    start = t.data_ptr()
    return (start + t.numel() * t.element_size() - 1) // 32 - start // 32 + 1


def row_sectors(t: torch.Tensor, ids: torch.Tensor) -> int:
    """Distinct 32-byte sectors of device memory that the rows of row-major
    ``t`` ([R, d] or [R]) at the kept ids (0 <= id < R) touch."""
    row_bytes = t.element_size() * (t.shape[1] if t.dim() > 1 else 1)
    u = torch.unique(ids.long())
    u = u[(u >= 0) & (u < t.shape[0])]
    first = (t.data_ptr() + u * row_bytes) // 32
    last = (t.data_ptr() + (u + 1) * row_bytes - 1) // 32
    span = torch.arange(int((last - first).max().item()) + 1, device=u.device)
    every = first[:, None] + span[None, :]
    return torch.unique(every[every <= last[:, None]]).numel()


def sector_bound_ms(sectors: int) -> float:
    """The least time to move ``sectors`` 32-byte sectors at the memory rate:
    what a launch that reads or writes whole sectors can reach."""
    return sectors * 32 / PEAK_BYTES_PER_S * 1e3


def rel_err(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """(max |got - want|, max |want|) in f32."""
    got, want = got.float(), want.float()
    return (got - want).abs().max().item(), want.abs().max().item()


def liven(state, gen: torch.Generator, rows_scale: float = 10.0, dim: int = DIM) -> None:
    """Give every kernel of the path a visible share of the logits, in
    place. ``Engine.init`` leaves the first-order column, ``w_dense``, the
    bias and DCN's cross biases at zero, and its N(0, 0.05) rows leave the
    second CIN pool near 1e-3 of a logit: a wrong ``wide_sum`` or p2 would
    still pass the GPU-vs-CPU check. Rows scaled by ``rows_scale`` (N(0,
    0.5) at 10), a first-order column (the fused table's last, of DIM + 1,
    or the dim-1 ``wide`` table) N(0, 0.2) and a drawn ``w_dense``, bias and
    cross bias fix that; ``term_sizes``, ``fm_term_sizes`` and
    ``cross_term_sizes`` check it. The FM term grows with the square of the
    rows: FM and DeepFM take 3 (N(0, 0.15)), which keeps their logits within
    a few units, where the sigmoid does not saturate. LR has only the
    ``wide`` table, PNN neither a first-order column nor ``w_dense`` and the
    bias; AFM's attention-pooled pairs are a weighted mean of 325 products
    far smaller than the rows, so its ``p`` is scaled by ``rows_scale`` too
    (no draw)."""
    wide = state.emb_params.get("wide", {})
    for table in state.emb_params.get("emb", {}).values():
        if wide or table.shape[1] != dim + 1:  # no fused first-order column
            table *= rows_scale
        else:
            table[:, :-1] *= rows_scale
            table[:, -1] = torch.randn(table.shape[0], generator=gen, device=table.device) * 0.2
    for table in wide.values():
        table.copy_(torch.randn(table.shape, generator=gen, device=table.device) * 0.2)
    dp = state.dense_params
    dev = state.step.device
    if "w_dense" in dp:
        dp["w_dense"] = torch.randn(dp["w_dense"].shape, generator=gen, device=dev) * 0.1
    if "cross" in dp:
        dp["cross"]["b"] = torch.randn(dp["cross"]["b"].shape, generator=gen, device=dev) * 0.1
    if "p" in dp:
        dp["p"] = dp["p"] * rows_scale
    if "bias" in dp:
        dp["bias"] = torch.randn((), generator=gen, device=dev) * 0.1


def term_sizes(pred, dense, ids) -> dict[str, float]:
    """Largest |contribution| to a logit of ``wide_sum``, p1 . w_cin and
    p2 . w_cin over the examples given (xDeepFM with CIN(h1, h2)), through
    the predictor's own wrappers (the plain versions for a CPU predictor)
    and the model's own choice of CIN route."""
    from recmodels_tpu_torch.embedding.gather import gather_rows
    from recmodels_tpu_torch.ops.cuda.interactions_cuda import cin_stack_dm_flat, split_fused_rows

    eng, st = pred.engine, pred.state
    dt = eng.model.compute_dtype
    coll = eng.collections["emb"]
    (g,) = coll.groups
    with torch.inference_mode():
        gids = coll.group_row_ids(torch.as_tensor(ids, device=pred.device))[g.name]
        full = gather_rows(st.emb_params["emb"][g.name], gids, dt)
        x_dm, ws = split_fused_rows(full, g.dim - 1)
        w_cin_k = [w.to(dt) for w in st.dense_params["cin_w"]]
        pools = cin_stack_dm_flat(x_dm, w_cin_k).float()
        w_cin = st.dense_params["w_cin"]
        h1 = w_cin_k[1].shape[0]
        return {"wide_sum": ws.abs().max().item(),
                "p1 . w_cin": (pools[:, :h1] @ w_cin[:h1]).abs().max().item(),
                "p2 . w_cin": (pools[:, h1:] @ w_cin[h1:]).abs().max().item()}


def fm_term_sizes(pred, dense, ids) -> dict[str, float]:
    """Largest |FM term| (DeepFM, FM) over the examples given: the fused
    rows gathered in the model's dtype and the term of their view
    ``full[..., :DIM]``, through the predictor's own wrappers."""
    from recmodels_tpu_torch.embedding.gather import gather_rows
    from recmodels_tpu_torch.ops.cuda.interactions_cuda import fm_pairwise_forward

    eng, st = pred.engine, pred.state
    coll = eng.collections["emb"]
    (g,) = coll.groups
    with torch.inference_mode():
        gids = coll.group_row_ids(torch.as_tensor(ids, device=pred.device))[g.name]
        full = gather_rows(st.emb_params["emb"][g.name], gids,
                           getattr(eng.model, "compute_dtype", torch.float32))
        return {"FM term": fm_pairwise_forward(full[..., : g.dim - 1]).abs().max().item()}


def cross_term_sizes(pred, dense, ids) -> dict[str, float]:
    """Largest |(x_L - x0) . w_out[:d]| (DCN) over the examples given: what
    the cross layers add to a logit beyond passing x0 through, through the
    predictor's own wrappers."""
    from recmodels_tpu_torch.embedding.gather import gather_rows
    from recmodels_tpu_torch.ops.cuda.interactions_cuda import dcn_cross_stack_forward

    eng, st = pred.engine, pred.state
    coll = eng.collections["emb"]
    (g,) = coll.groups
    dt = eng.model.compute_dtype
    dp = st.dense_params
    with torch.inference_mode():
        ids_t = torch.as_tensor(ids, device=pred.device)
        rows = gather_rows(st.emb_params["emb"][g.name], coll.group_row_ids(ids_t)[g.name], dt)
        x0 = torch.cat([rows.reshape(rows.shape[0], -1),
                        torch.as_tensor(dense, device=pred.device).to(dt)], dim=1)
        xl = dcn_cross_stack_forward(x0, dp["cross"]["w"].to(dt), dp["cross"]["b"].to(dt))
        part = (xl.float() - x0.float()) @ dp["w_out"][: x0.shape[1]]
        return {"(x_L - x0) . w_out": part.abs().max().item()}


def zoo_term_sizes(pred, dense, ids) -> dict[str, float]:
    """Largest |contribution| to a logit over the examples given, for LR,
    PNN, Wide&Deep, NFM and AFM, from the rows gathered through the
    predictor's own wrapper: the first-order sum (all but PNN), and the
    interaction term where the model has one: PNN's products (the MLP of
    its input against the MLP of it with the product features zeroed),
    NFM's MLP of the bi-interaction against the MLP of zeros, AFM's
    attention-pooled pairs (the logit less its linear terms)."""
    from recmodels_tpu_torch.nn.mlp import mlp_apply
    from recmodels_tpu_torch.ops.dispatch import get_op
    from recmodels_tpu_torch.ops.interactions import fm_bi_interaction

    eng, st = pred.engine, pred.state
    model, dp = eng.model, st.dense_params
    with torch.inference_mode():
        ids_t = torch.as_tensor(ids, device=pred.device)
        dense_t = torch.as_tensor(dense, device=pred.device)
        rows = eng.tables.gather(st.emb_params, eng._group_ids(ids_t), eng._gather_dtype)
        ((_, groups),) = rows.items()
        (full,) = groups.values()
        if model.name == "lr":
            return {"wide_sum": full.float().sum(dim=(1, 2)).abs().max().item()}
        cd = model.compute_dtype
        if model.name == "pnn":
            b = full.shape[0]
            z = [full.reshape(b, -1), dense_t.to(full.dtype)]
            parts = []
            if model.mode in ("inner", "both"):
                parts.append(get_op("pnn_inner_products")(full))
            if model.mode in ("outer", "both"):
                parts.append(get_op("pnn_outer_product")(full).reshape(b, -1))
            p = torch.cat(parts, dim=1)
            y, y0 = (mlp_apply(dp["mlp"], torch.cat(z + [q], dim=1), final_linear=True, compute_dtype=cd)
                     for q in (p, torch.zeros_like(p)))
            return {"products": (y - y0).abs().max().item()}
        e, wide = full[..., :DIM], full[..., DIM:].float()
        ws = wide[..., 0].sum(dim=1)
        out = {"wide_sum": ws.abs().max().item()}
        if model.name == "nfm":
            bi = fm_bi_interaction(e)
            y = mlp_apply(dp["mlp"], bi, final_linear=True, compute_dtype=cd)
            y0 = mlp_apply(dp["mlp"], torch.zeros_like(bi), final_linear=True, compute_dtype=cd)
            out["MLP(bi) - MLP(0)"] = (y - y0).abs().max().item()
        if model.name == "afm":
            logit = model.apply(dp, dense_t, {"emb": e, "wide": wide})
            linear = dp["bias"] + ws + dense_t @ dp["w_dense"]
            out["p . pooled"] = (logit - linear).abs().max().item()
        return out


def to_device(tree, device):
    """A copy of a state's tensors (dicts, lists, NamedTuples) on ``device``."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to(device, copy=True)
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(to_device(v, device) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_device(v, device) for v in tree)
    return tree


def adagrad_library_step(table, ids, grads, lr, eps):
    """torch.optim.Adagrad's sparse step on the same update (its sparse path
    sums duplicates, adds g^2 to the accumulator and divides by sqrt + eps,
    from an accumulator of 0.1), ready to time: the yardstick, used nowhere
    in the port."""
    keep = ids < table.shape[0]
    param = torch.nn.Parameter(table.clone())
    param.grad = torch.sparse_coo_tensor(ids[keep].long()[None], grads[keep].float(),
                                         size=table.shape, check_invariants=False)
    opt = torch.optim.Adagrad([param], lr=lr, eps=eps, initial_accumulator_value=0.1)
    return opt.step


def check_step(name: str, got: torch.Tensor, want: torch.Tensor, before: torch.Tensor) -> float:
    """GPU step vs CPU step of one tensor: max |got - want| within
    STEP_REL_TOL of the CPU step's largest change. Returns the error."""
    got, want, before = got.detach().cpu().float(), want.float(), before.float()
    err = (got - want).abs().max().item()
    change = (want - before).abs().max().item()
    check(change > 0 and err <= STEP_REL_TOL * change,
          f"{name}: GPU step within {STEP_REL_TOL} of the CPU step's change "
          f"(err {err:.6g}, change {change:.6g})")
    return err


def adam_library_step(table, ids, grads, lr):
    """torch.optim.SparseAdam's step on the same update (it sums duplicates
    and updates the moments of the touched rows only, lazy Adam's rule),
    ready to time: the yardstick, used nowhere in the port."""
    keep = ids < table.shape[0]
    param = torch.nn.Parameter(table.clone())
    param.grad = torch.sparse_coo_tensor(ids[keep].long()[None], grads[keep].float(),
                                         size=table.shape, check_invariants=False)
    opt = torch.optim.SparseAdam([param], lr=lr)
    return opt.step


def adam_step_of(before_table, m, v, scalars: torch.Tensor) -> torch.Tensor:
    """The table after lazy Adam's step from its new moments m and v (on the
    CPU, in the update's order of operations and f32 constants), with the
    step's [lr, bc1, bc2] as the card computed them."""
    from recmodels_tpu_torch.embedding.update import adam_constants

    c = adam_constants(0.9, 0.999, 1e-8)
    lr, bc1, bc2 = scalars.cpu().unbind()
    den = torch.sqrt((v / bc2).double()).float() + c["eps"]
    return before_table + (-lr * (m / bc1)) / den


def cin_macs(rows: int, b: int, m: int, h1: int, h2: int) -> tuple[int, int]:
    """Multiply-adds of the fused two-layer CIN's forward and backward in
    its pair-pool form (the forms ``csrc/cin2.cu`` and ``csrc/cin2_bwd.cu``
    state) at rows = B * D."""
    fwd = rows * m * m * h1 + rows * m * h1 + b * m * h1 * h2
    bwd = 2 * rows * m * m * h1 + 2 * b * h2 * m * h1 + 2 * rows * m * h1 + 2 * rows * m * m
    return fwd, bwd


def cin2_padded_rows(report: dict, x02: torch.Tensor, m: int, dev) -> None:
    """#3 and #5 at the benchmark's xDeepFM CIN(200,200), zero-padded to
    208 as ``cin_stack_dm_flat`` runs it (``cin2_route_widths``,
    ``cin2_pad_weights``), on the same x0 [262144, 26]: weights at the
    model's initial scale and pool grads N(0, 1), cut to 200 and padded
    with zeros as the route's are, from a generator of their own (the later
    phases' draws do not move). Each time beside its plain version's at
    208, its bound from the 200-wide CIN's own operations and bytes (the
    padding is work the CIN does not need), and the route's pad of the
    weights (device time); then the whole route's forward and backward
    against ``Cin2`` on weights padded beforehand, by device time, whose
    difference is what the pad and the cuts cost a step. Keys ``w208_`` in the rows ``cin2_forward`` and
    ``cin2_backward``."""
    from recmodels_tpu_torch.ops.cuda.interactions_cuda import (
        Cin2, cin2_backward, cin2_backward_reference, cin2_forward, cin2_forward_reference, cin2_pad_weights,
        cin2_route_widths, cin_stack_dm_flat,
    )

    h = 200
    hp = cin2_route_widths(DIM, m, h, h, torch.bfloat16)
    check(hp == (208, 208), f"CIN({h},{h}) takes the fused route at {hp}")
    gen = torch.Generator(device=dev).manual_seed(SEED + 208)
    w1 = (torch.randn((m, m * h), generator=gen, device=dev) * (2.0 / (m * m)) ** 0.5).to(torch.bfloat16)
    w2 = (torch.randn((h, m * h), generator=gen, device=dev) * (2.0 / (h * m)) ** 0.5).to(torch.bfloat16)
    w1p, w2p = cin2_pad_weights(w1, w2, m, *hp)
    rows = x02.shape[0]
    fwd_macs, bwd_macs = cin_macs(rows, BATCH, m, h, h)

    outs = cin2_forward(x02, w1p, w2p, DIM, want_x1=True, want_q=True)
    refs = cin2_forward_reference(x02, w1p, w2p, DIM, want_x1=True, want_q=True)
    errs = []
    for name, o, r in zip(("x1", "p1", "p2", "Q"), outs, refs):
        err, scale = rel_err(o, r)
        print(f"cin2_forward w208 {name}: max err {err:.6g}, max |ref| {scale:.6g}, tol {BF16_REL_TOL * scale:.6g}")
        check(err <= BF16_REL_TOL * scale, f"cin2_forward w208 {name} within {BF16_REL_TOL} of max |ref|")
        errs.append((err, BF16_REL_TOL * scale))
    x1, p1, p2, q = outs
    check(not x1[:, h:].any() and not p1[:, h:].any() and not p2[:, h:].any()
          and not q.reshape(BATCH, m, hp[0])[..., h:].any(), "cin2_forward w208: the padded channels are zeros")
    del refs
    b_ms, b_by = bound_ms((x02.numel() + w1.numel() + w2.numel() + BATCH * 2 * h) * 2, 2 * fwd_macs)
    report["cin2_forward"].update(
        w208_max_abs_err=max(e for e, _ in errs), w208_tol=max(t for _, t in errs),
        w208_ms=time_ms(lambda: cin2_forward(x02, w1p, w2p, DIM)),
        w208_plain_ms=time_ms(lambda: cin2_forward_reference(x02, w1p, w2p, DIM), iters=5),
        w208_library_ms=None, w208_bound_ms=b_ms, w208_bound_by=b_by,
        w208_pad_ms=device_ms(lambda: cin2_pad_weights(w1, w2, m, *hp)),
        w208_launch_ms=launch_split(lambda: cin2_forward(x02, w1p, w2p, DIM), calls=10),
        w208_launch_ms_train=launch_split(
            lambda: cin2_forward(x02, w1p, w2p, DIM, want_x1=True, want_q=True), calls=10),
        w208_shapes=f"CIN({h},{h}) padded to {hp}: x0 [{rows}, {m}], w1 [{m}, {m * hp[0]}], "
                    f"w2 [{hp[0]}, {m * hp[1]}]; bound_ms counts the {h}-wide CIN",
    )

    pad = torch.nn.functional.pad
    g1p = pad(torch.randn((BATCH, h), generator=gen, device=dev), (0, hp[0] - h)).to(torch.bfloat16)
    g2p = pad(torch.randn((BATCH, h), generator=gen, device=dev), (0, hp[1] - h)).to(torch.bfloat16)
    bwd = cin2_backward(x02, x1, w1p, w2p, q, g1p, g2p, DIM)
    ref = cin2_backward_reference(x02, x1, w1p, w2p, q, g1p, g2p, DIM)
    errs = []
    for name, o, r in zip(("gx0", "gw1", "gw2"), bwd, ref):
        err, scale = rel_err(o, r)
        print(f"cin2_backward w208 {name}: max err {err:.6g}, max |ref| {scale:.6g}, tol {BF16_REL_TOL * scale:.6g}")
        check(err <= BF16_REL_TOL * scale, f"cin2_backward w208 {name} within {BF16_REL_TOL} of max |ref|")
        errs.append((err, BF16_REL_TOL * scale))
    gw1, gw2 = bwd[1].reshape(m, m, hp[0]), bwd[2].reshape(hp[0], m, hp[1])
    check(not gw1[..., h:].any() and not gw2[h:].any() and not gw2[..., h:].any(),
          "cin2_backward w208: the padded weights' gradients are zeros")
    check(all(torch.equal(a, b) for a, b in zip(bwd, cin2_backward(x02, x1, w1p, w2p, q, g1p, g2p, DIM))),
          "cin2_backward w208 repeats bit for bit")
    del ref
    nbytes = (x02.numel() + rows * h + w1.numel() + w2.numel() + BATCH * m * h + BATCH * 2 * h
              + x02.numel() + w1.numel() + w2.numel()) * 2
    b_ms, b_by = bound_ms(nbytes, 2 * bwd_macs)
    report["cin2_backward"].update(
        w208_max_abs_err=max(e for e, _ in errs), w208_tol=max(t for _, t in errs),
        w208_ms=time_ms(lambda: cin2_backward(x02, x1, w1p, w2p, q, g1p, g2p, DIM)),
        w208_plain_ms=time_ms(lambda: cin2_backward_reference(x02, x1, w1p, w2p, q, g1p, g2p, DIM), iters=3),
        w208_library_ms=None, w208_bound_ms=b_ms, w208_bound_by=b_by,
        w208_launch_ms=launch_split(lambda: cin2_backward(x02, x1, w1p, w2p, q, g1p, g2p, DIM), calls=10),
    )
    for name in ("cin2_forward", "cin2_backward"):
        r = report[name]
        print(f"{name} w208: {r['w208_ms']:.4f} ms (w128 {r['ms']:.4f}), bound {r['w208_bound_ms']:.4f} "
              f"({r['w208_bound_by']}), plain {r['w208_plain_ms']:.4f}")
    del bwd, x1, p1, p2, q, outs

    # the route's own cost: the device time of cin_stack_dm_flat forward and
    # backward at width 200 against Cin2 on weights padded beforehand (the
    # same kernels but the pad of the weights and the cut of their grads),
    # in turns; events over back-to-back eager calls would time the host
    x_dm = x02.reshape(BATCH, DIM, m)
    cot = torch.randn((BATCH, 2 * h), generator=gen, device=dev).to(torch.bfloat16)

    def route():
        ins = [t.detach().requires_grad_(True) for t in (x_dm, w1, w2)]
        pools = cin_stack_dm_flat(ins[0], ins[1:])
        torch.autograd.grad((pools.float() * cot.float()).sum(), ins)

    def prepadded():
        ins = [t.detach().requires_grad_(True) for t in (x02, w1p, w2p)]
        p1, p2 = Cin2.apply(*ins, DIM)
        pools = torch.cat([p1[:, :h], p2[:, :h]], 1)
        torch.autograd.grad((pools.float() * cot.float()).sum(), ins)

    turns = [launch_split(fn, calls=10) for fn in (prepadded, route, route, prepadded)]
    ms = [sum(t.values()) for t in turns]
    pad_ms = (ms[1] + ms[2] - ms[0] - ms[3]) / 2
    report["cin2_backward"].update(w208_route_ms=(ms[1] + ms[2]) / 2, w208_prepadded_ms=(ms[0] + ms[3]) / 2,
                                   w208_route_pad_ms=pad_ms, w208_route_launch_ms=turns[2],
                                   w208_prepadded_launch_ms=turns[3])
    print(f"CIN(200,200) route forward and backward, device time: {ms[1]:.4f}, {ms[2]:.4f} ms against "
          f"{ms[0]:.4f}, {ms[3]:.4f} prepadded: the pad and cuts {pad_ms:.4f} ms a step")


def slice3_kernels(report: dict, engine3, ids, card: str, gen: torch.Generator) -> None:
    """The kernels of the slice-3 path against their plain versions at its
    shapes; adds their rows to ``report``."""
    from recmodels_tpu_torch.embedding.optim import slot_sorted_ids
    from recmodels_tpu_torch.embedding.update import (
        adam_scalars, sorted_adam_update, sorted_adam_update_reference,
    )
    from recmodels_tpu_torch.ops.cuda.interactions_cuda import (
        cin_layer_backward, cin_layer_backward_einsum, cin_layer_backward_reference, cin_layer_forward,
        cin_layer_forward_reference, transpose_minor2, transpose_minor2_reference,
    )

    dev = torch.device("cuda")
    coll = engine3.collections["emb"]
    (grp,) = coll.groups
    rows, m = grp.alloc_rows, engine3.model.schema.n_slots

    # 7. sorted_adam_update: the batch's sorted stream (425,984 ids) into the
    # 2,600,960 x 16 table, then a dim-1 table; bf16 grads N(0, 0.01), step
    # 30, the block [lr, bc1, bc2] computed on the card from a step tensor
    # and read by the kernel from device memory
    sorted_ids, _, _ = slot_sorted_ids(coll.group_row_ids(ids)[grp.name])
    n = sorted_ids.numel()
    touched = torch.unique(sorted_ids).numel()
    scalars = adam_scalars(torch.tensor(1e-2, device=dev), torch.tensor(30, dtype=torch.int32, device=dev),
                           0.9, 0.999)
    hyper = dict(scalars=scalars, b1=0.9, b2=0.999, eps=1e-8)
    update = {}
    for label, d in (("", DIM), ("dim1_", 1)):
        shape = (rows, d) if d > 1 else (rows,)
        table = torch.randn(shape, generator=gen, device=dev) * 0.05
        mom = torch.randn(shape, generator=gen, device=dev) * 1e-3
        vel = mom * mom * 10.0 + 1e-10  # a history: sqrt(v) outgrows |m|, as Adam's moments do
        grads = (torch.randn((n, *shape[1:]), generator=gen, device=dev) * 0.01).to(torch.bfloat16)
        cpu = [t.cpu() for t in (table, mom, vel)]
        sorted_adam_update_reference(*cpu, sorted_ids.cpu(), grads.cpu(), **{**hyper, "scalars": scalars.cpu()})
        sorted_adam_update(table, mom, vel, sorted_ids, grads, **hyper)
        torch.cuda.synchronize()
        err = max((a.cpu() - b).abs().max().item() for a, b in zip((table, mom, vel), cpu))
        check(err == 0.0, f"sorted_adam_update {label or 'd16 '}bit-exact against the CPU plain version ({err})")
        b_ms, b_by = bound_ms(n * 4 + grads.numel() * 2 + touched * d * 4 * 6)
        # each touched sector of the table, m and v read once and written once
        sectors = range_sectors(sorted_ids) + range_sectors(grads) + 2 * sum(
            row_sectors(t, sorted_ids) for t in (table, mom, vel))
        update.update({f"{label}max_abs_err": err, f"{label}bound_ms": b_ms, f"{label}bound_by": b_by,
                       f"{label}sector_bound_ms": sector_bound_ms(sectors)})
        kernel = lambda: sorted_adam_update(table, mom, vel, sorted_ids, grads, **hyper)  # noqa: E731
        plain = lambda: sorted_adam_update_reference(table, mom, vel, sorted_ids, grads, **hyper)  # noqa: E731
        library = adam_library_step(table, sorted_ids, grads, 1e-2)
        update.update(short_times(kernel, plain, library, label))
        del table, mom, vel, grads, cpu
    report["sorted_adam_update"] = dict(
        route="cuda", source="recmodels_tpu_torch/csrc/adam_update.cu",
        replaces="recmodels_tpu/embedding/pallas_update.py:559", tol=0.0, timing=SHORT_TIMING, **update,
    )

    # 9. cin_layer_forward: x0 [262144, 26] N(0, 1) and the model's initial
    # CIN weights; layer 1 (Hk = 26) and layer 2 (Hk = 128, its input layer
    # 1's output), in bf16 and f32
    x02 = torch.randn((BATCH * DIM, m), generator=gen, device=dev).to(torch.bfloat16)
    w1, w2 = (w.to(torch.bfloat16) for w in engine3.model.init_dense(gen, dev)["cin_w"][:2])
    xk2 = cin_layer_forward(x02, x02, w1)
    fwd = {}
    for label, (xk, x0, w) in (("", (xk2, x02, w2)), ("l1_", (x02, x02, w1)),
                               ("f32_", (xk2.float(), x02.float(), w2.float())),
                               ("l1_f32_", (x02.float(), x02.float(), w1.float()))):
        f32 = xk.dtype == torch.float32
        got = cin_layer_forward(xk, x0, w)
        err, scale = rel_err(got, cin_layer_forward_reference(xk, x0, w))
        tol = (F32_LAYER_REL_TOL if f32 else BF16_REL_TOL) * scale
        print(f"cin_layer_forward {label or 'l2_'}[{xk.shape[0]}, {xk.shape[1]}]: max err {err:.6g}, "
              f"max |ref| {scale:.6g}, tol {tol:.6g}")
        check(err <= tol, f"cin_layer_forward {label or 'l2_'}within tolerance of the plain version")
        r, hk = xk.shape
        hn = w.shape[1] // m
        b_ms, b_by = bound_ms((xk.numel() + x0.numel() + w.numel() + got.numel()) * xk.element_size(),
                              2 * r * hk * m * hn, PEAK_F32_FLOP_PER_S if f32 else PEAK_BF16_FLOP_PER_S)
        w3 = w.reshape(hk, m, hn)
        check(torch.equal(got, cin_layer_forward(xk, x0, w)), f"cin_layer_forward {label or 'l2_'}repeats bit for bit")
        kernel = lambda: cin_layer_forward(xk, x0, w)  # noqa: E731
        library = lambda: torch.einsum("rh,hin,ri->rn", xk, w3, x0)  # noqa: E731
        fwd.update({
            f"{label}max_abs_err": err, f"{label}tol": tol, f"{label}bound_ms": b_ms, f"{label}bound_by": b_by,
            f"{label}ms": time_ms(kernel, iters=10),
            f"{label}plain_ms": time_ms(lambda: cin_layer_forward_reference(xk, x0, w), iters=3),
            f"{label}library_ms": time_ms(library, iters=3),
            f"{label}warm_ms": device_ms(kernel, calls=5),
            f"{label}library_warm_ms": device_ms(library, calls=3),
        })
        if not f32:  # the re-layout (layer 1) and the product kernel apart
            fwd[f"{label}launch_ms"] = launch_split(kernel, calls=10)
        del got
    for label in ("", "l1_"):
        split = ", ".join(f"{k} {v:.4f}" for k, v in fwd[f"{label}launch_ms"].items())
        print(f"cin_layer_forward {label or 'l2_'}bf16 launches by device time (ms a call): {split} on {card}")
    report["cin_layer_forward"] = dict(
        route="cuda", source="recmodels_tpu_torch/csrc/cin_layer.cu",
        replaces="recmodels_tpu/ops/pallas/interactions_tpu.py:234",
        shapes="unprefixed keys: layer 2 bf16 [262144, 128] x [128, 26*128]; l1_: layer 1 "
               "[262144, 26] x [26, 26*128]; f32_ and l1_f32_: the same in f32",
        timing="ms, plain_ms, library_ms: CUDA events over back-to-back calls; warm_ms, library_warm_ms: "
               "the same calls by torch.profiler; launch_ms, l1_launch_ms: each launch of the bf16 calls by "
               "torch.profiler", **fwd,
    )

    # 10. cin_layer_backward at layer 2: the output's cotangent N(0, 1)
    gy = torch.randn((BATCH * DIM, w2.shape[1] // m), generator=gen, device=dev).to(torch.bfloat16)
    outs = cin_layer_backward(xk2, x02, w2, gy)
    refs = cin_layer_backward_reference(xk2, x02, w2, gy)
    errs = []
    for name, o, r in zip(("gxk", "gx0", "gw"), outs, refs):
        err, scale = rel_err(o, r)
        print(f"cin_layer_backward {name}: max err {err:.6g}, max |ref| {scale:.6g}, "
              f"tol {BF16_REL_TOL * scale:.6g}")
        check(err <= BF16_REL_TOL * scale, f"cin_layer_backward {name} within {BF16_REL_TOL} of max |ref|")
        errs.append((err, BF16_REL_TOL * scale))
    check(all(torch.equal(a, b) for a, b in zip(outs, cin_layer_backward(xk2, x02, w2, gy))),
          "cin_layer_backward repeats bit for bit")
    del refs
    r, hk = xk2.shape
    hn = w2.shape[1] // m
    nbytes = (xk2.numel() + x02.numel() + w2.numel() + gy.numel() + sum(t.numel() for t in outs)) * 2
    b_ms, b_by = bound_ms(nbytes, 4 * r * hk * m * hn)
    kernel = lambda: cin_layer_backward(xk2, x02, w2, gy)  # noqa: E731
    report["cin_layer_backward"] = dict(
        route="cuda", source="recmodels_tpu_torch/csrc/cin_layer_bwd.cu",
        replaces="recmodels_tpu/ops/pallas/interactions_tpu.py:379",
        max_abs_err=max(e for e, _ in errs), tol=max(t for _, t in errs),
        ms=time_ms(kernel, iters=10),
        warm_ms=device_ms(kernel, calls=10),
        launch_ms=launch_split(kernel, calls=10),
        plain_ms=time_ms(lambda: cin_layer_backward_reference(xk2, x02, w2, gy), iters=3),
        einsum_ms=time_ms(lambda: cin_layer_backward_einsum(xk2, x02, w2, gy), iters=3),
        library_ms=None, bound_ms=b_ms, bound_by=b_by,
        timing="ms, plain_ms, einsum_ms: CUDA events over back-to-back calls; warm_ms, launch_ms: "
               "torch.profiler, the sum and each launch; einsum_ms: cin_layer_backward_einsum, the "
               "JAX package's einsum backward in five PyTorch calls (a yardstick, not one library call)",
    )
    del outs, gy, xk2, x02

    # 11. transpose_minor2 on the field matrix [16384, 26, 16] bf16
    x = torch.randn((BATCH, m, DIM), generator=gen, device=dev).to(torch.bfloat16)
    got = transpose_minor2(x)
    check(torch.equal(got, transpose_minor2_reference(x)), "transpose_minor2 exact")
    b_ms, b_by = bound_ms(2 * x.numel() * 2)
    report["transpose_minor2"] = dict(
        route="cuda", source="recmodels_tpu_torch/csrc/transpose.cu",
        replaces="recmodels_tpu/ops/pallas/interactions_tpu.py:180", max_abs_err=0.0, tol=0.0,
        bound_ms=b_ms, bound_by=b_by, timing=SHORT_TIMING,
        **short_times(lambda: transpose_minor2(x), lambda: transpose_minor2_reference(x),
                      lambda: x.transpose(1, 2).contiguous()),
    )


def slice4_kernels(report: dict, card: str, gen: torch.Generator) -> None:
    """The kernels of the slice-4 paths against their plain versions at
    their shapes; adds their rows to ``report``."""
    from recmodels_tpu_torch.ops.cuda.interactions_cuda import (
        dcn_cross_stack_forward, dcn_cross_stack_forward_reference, dcn_cross_stack_in_kernel_order,
        dcn_cross_stack_scale, fm_pairwise_forward, fm_pairwise_forward_reference,
    )

    dev = torch.device("cuda")
    m = 26

    # 12. fm_pairwise on the stride-17 view full[..., :16] of gathered rows
    # N(0, 1): DeepFM's [16384, 26, 17] bf16 and FM's [8192, 26, 17] f32.
    # The term cancels, so each example is held to a share of
    # ||sum e||^2 + sum ||e||^2: 1% in bf16, F32_REL_TOL in f32
    fm = {}
    for label, b, dtype, rel in (("", BATCH, torch.bfloat16, BF16_REL_TOL),
                                 ("f32_", FM_BATCH, torch.float32, F32_REL_TOL)):
        full = torch.randn((b, m, DIM + 1), generator=gen, device=dev).to(dtype)
        emb = full[..., :DIM]
        got = fm_pairwise_forward(emb)
        want = fm_pairwise_forward_reference(emb)
        e = emb.double()
        scale = (e.sum(1) ** 2).sum(1) + (e ** 2).sum((1, 2))
        err_ex = (got.double() - want.double()).abs()
        worst = (err_ex / scale).max().item()
        print(f"fm_pairwise {label or 'bf16_'}[{b}, {m}, {DIM}] view of [{b}, {m}, {DIM + 1}]: max err "
              f"{err_ex.max().item():.6g}, largest share of the scale {worst:.3g}, tol {rel}")
        check(got.shape == (b,) and got.dtype == dtype and worst <= rel,
              f"fm_pairwise {label or 'bf16 '}within {rel} of each example's scale")
        esize = emb.element_size()
        b_ms, b_by = bound_ms(emb.numel() * esize + b * esize, 3 * emb.numel(), PEAK_F32_FLOP_PER_S)
        fm.update({
            f"{label}max_abs_err": err_ex.max().item(), f"{label}tol": rel, f"{label}max_rel_err": worst,
            f"{label}bound_ms": b_ms, f"{label}bound_by": b_by,
            **short_times(lambda: fm_pairwise_forward(emb), lambda: fm_pairwise_forward_reference(emb),
                          prefix=label),
        })
        del full, emb, got, want, e
    report["fm_pairwise_forward"] = dict(
        route="cuda", source="recmodels_tpu_torch/csrc/fm_pairwise.cu",
        replaces="recmodels_tpu/ops/pallas/interactions_tpu.py:53",
        shapes="unprefixed keys: DeepFM, the [16384, 26, 16] bf16 view of [16384, 26, 17] rows; "
               "f32_: FM, the [8192, 26, 16] f32 view of [8192, 26, 17] rows; tol is a share of "
               "each example's ||sum e||^2 + sum ||e||^2", timing=SHORT_TIMING, **fm,
    )

    # 13. dcn_cross_stack: DCN's x0 [16384, 429] N(0, 1), w N(0, 1/sqrt(429))
    # (the model's init) and a bias N(0, 0.1) of 3 layers, bf16 and f32. Each
    # element is held to a share of dcn_cross_stack_scale (x_L is
    # heavy-tailed, so a share of max |x_L| would let its largest values set
    # the limit for all), and in bf16 the kernel must give the plain version
    # summed in its own order bit for bit: a rounding point missed or moved
    # shows there however small it is
    d = m * DIM + 13
    dcn = {}
    for label, dtype, rel in (("", torch.bfloat16, DCN_BF16_REL_TOL), ("f32_", torch.float32, F32_REL_TOL)):
        x0 = torch.randn((BATCH, d), generator=gen, device=dev).to(dtype)
        w = (torch.randn((N_CROSS, d), generator=gen, device=dev) / d ** 0.5).to(dtype)
        bias = (torch.randn((N_CROSS, d), generator=gen, device=dev) * 0.1).to(dtype)
        got = dcn_cross_stack_forward(x0, w, bias)
        err_el = (got.double() - dcn_cross_stack_forward_reference(x0, w, bias).double()).abs()
        scale = dcn_cross_stack_scale(x0, w, bias)
        worst = (err_el / scale).max().item()
        err = err_el.max().item()
        print(f"dcn_cross_stack {label or 'bf16_'}[{BATCH}, {d}], L = {N_CROSS}: max err {err:.6g}, "
              f"largest share of the element's scale {worst:.3g}, tol {rel}")
        check(got.shape == x0.shape and got.dtype == dtype and worst <= rel,
              f"dcn_cross_stack {label or 'bf16 '}within {rel} of each element's scale")
        if dtype == torch.bfloat16:
            in_order = dcn_cross_stack_in_kernel_order(x0, w, bias)
            print(f"dcn_cross_stack bf16: {int((got != in_order).sum())} of {got.numel()} elements differ "
                  "from the plain version summed in the kernel's order")
            check(torch.equal(got, in_order), "dcn_cross_stack bf16 bit for bit the plain version "
                  "summed in the kernel's order")
            del in_order
        check(torch.equal(got, dcn_cross_stack_forward(x0, w, bias)), "dcn_cross_stack repeats bit for bit")
        digest = hashlib.sha256(got.contiguous().view(torch.uint8).cpu().numpy().tobytes()).hexdigest()
        print(f"dcn_cross_stack {label or 'bf16_'}output sha256 {digest}")
        esize = x0.element_size()
        b_ms, b_by = bound_ms((2 * x0.numel() + w.numel() + bias.numel()) * esize,
                              5 * N_CROSS * x0.numel(), PEAK_F32_FLOP_PER_S)
        dcn.update({
            f"{label}max_abs_err": err, f"{label}tol": rel, f"{label}max_rel_err": worst,
            f"{label}bound_ms": b_ms, f"{label}bound_by": b_by, f"{label}sha256": digest,
            **short_times(lambda: dcn_cross_stack_forward(x0, w, bias),
                          lambda: dcn_cross_stack_forward_reference(x0, w, bias), prefix=label),
        })
        del x0, w, bias, got, err_el, scale
    report["dcn_cross_stack_forward"] = dict(
        route="cuda", source="recmodels_tpu_torch/csrc/dcn_cross.cu",
        replaces="recmodels_tpu/ops/pallas/interactions_tpu.py:98",
        shapes=f"unprefixed keys: x0 [16384, {d}] bf16, w and b [3, {d}]; f32_: the same in f32; tol is "
               "a share of each element's dcn_cross_stack_scale", timing=SHORT_TIMING, **dcn,
    )


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from recmodels_tpu_torch.data import SyntheticSource
    from recmodels_tpu_torch.embedding.gather import gather_rows, gather_rows_reference
    from recmodels_tpu_torch.embedding.optim import slot_sorted_ids
    from recmodels_tpu_torch.embedding.update import (
        sorted_adagrad_update, sorted_adagrad_update_reference,
    )
    from recmodels_tpu_torch.models import build_model
    from recmodels_tpu_torch.ops.cuda import build
    from recmodels_tpu_torch.ops.cuda.interactions_cuda import (
        cin2_backward, cin2_backward_reference, cin2_forward, cin2_forward_reference, cin_layer_forward,
        dcn_cross_stack_forward, fm_pairwise_forward, split_fused_rows, split_fused_rows_backward,
        split_fused_rows_backward_reference, split_fused_rows_reference,
    )
    from recmodels_tpu_torch.train.engine import Engine
    from recmodels_tpu_torch.utils.config import TrainConfig, build_schema

    dev = torch.device("cuda")
    card = card_line()
    print("== card")
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    # ---------------------------------------------------------------- build
    print("== build")
    fresh = not build.library_path().exists()
    t0 = time.perf_counter()
    lib_path = build.build()
    build.library()
    print(f"build: {time.perf_counter() - t0:.3f} s ({'built' if fresh else 'reused'}) {lib_path}")
    log = lib_path.parent / build.LOG_NAME
    if log.exists():
        for line in log.read_text().splitlines():
            if line.startswith("==") or "Used" in line or "spill" in line:
                print("  " + line.strip())

    cfg = TrainConfig(model="xdeepfm", bf16=True, vocab_size=VOCAB, embed_dim=DIM,
                      cin_sizes=CIN, hidden=HIDDEN, batch_size=BATCH, seed=SEED)
    schema = build_schema(cfg)
    engine = Engine(build_model(cfg.model, schema, **cfg.model_kwargs()))
    batch = next(iter(SyntheticSource(schema, batch_size=BATCH, seed=7)))
    ids = torch.as_tensor(batch.ids, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rows = engine.collections["emb"].groups[0].alloc_rows
    m = schema.n_slots

    # -------------------------------------------------------------- kernels
    print("== kernels (flagship shapes; the slice-3 paths' after the first six, then slice 4's)")
    report = {}

    # 1. gather: 26 x 1e5 ids (2,600,960 rows of 17 f32), batch-order ids;
    # then the other instances the paths launch, made from the same table
    # and ids (no new draws): f32 rows (f32 xDeepFM, FM), the table's first
    # 16 columns and its last (slice 3's two tables), the table with its
    # first 16 columns again (33 columns, dim 32's rows) and the first 26
    # and 26,000 ids (served requests of 1 and 1,000 examples), and the last
    # column gathered as f32 rows (LR's dim-1 table); each bit for bit its
    # plain version, and its library call index_select and the cast
    table = torch.randn((rows, DIM + 1), generator=gen, device=dev) * 0.05
    gids = engine.collections["emb"].group_row_ids(ids)["d17"]
    gather = {}
    instances = (("", table, gids, torch.bfloat16), ("f32_", table, gids, torch.float32),
                 ("d16_", table[:, :DIM].contiguous(), gids, torch.bfloat16),
                 ("d1_", table[:, DIM:].contiguous(), gids, torch.bfloat16),
                 ("d33_", torch.cat([table, table[:, :DIM]], 1), gids, torch.bfloat16),
                 ("req1_", table, gids.reshape(-1)[:m], torch.bfloat16),
                 ("req1000_", table, gids.reshape(-1)[:1000 * m], torch.bfloat16),
                 ("d1f32_", table[:, DIM:].contiguous(), gids, torch.float32))
    for label, t, i, dt in instances:
        rows_i = gather_rows(t, i, dt)
        ref = gather_rows_reference(t, i, dt)
        err = (rows_i.float() - ref.float()).abs().max().item()
        what = f"gather {label[:-1] or 'd17'} {dt}"
        check(torch.equal(rows_i, ref), f"{what} rows bit-exact (max err {err})")
        check(torch.equal(gather_rows(t, i, dt), rows_i), f"{what} repeats bit for bit")
        n, d1 = i.numel(), t.shape[1]
        b_ms, b_by = bound_ms(torch.unique(i).numel() * d1 * 4 + n * 4 + rows_i.numel() * dt.itemsize)
        sectors = row_sectors(t, i) + range_sectors(i) + range_sectors(rows_i)
        gather.update({f"{label}max_abs_err": err, f"{label}bound_ms": b_ms, f"{label}bound_by": b_by,
                       f"{label}sector_bound_ms": sector_bound_ms(sectors)})
        gather.update(short_times(lambda: gather_rows(t, i, dt), lambda: gather_rows_reference(t, i, dt),
                                  lambda: torch.index_select(t, 0, i.reshape(-1)).to(dt), prefix=label))
        del rows_i, ref
    del instances
    report["gather_rows"] = dict(
        route="cuda", source="recmodels_tpu_torch/csrc/gather.cu",
        replaces="recmodels_tpu/embedding/pallas_gather.py:180", tol=0.0, timing=SHORT_TIMING,
        shapes="unprefixed keys: 425,984 batch-order ids into the 2,600,960 x 17 f32 table, bf16 rows; "
               "f32_: f32 rows; d16_, d1_: the table's first 16 columns and its last (d16_ is also PNN's "
               "instance); d33_: the table and its first 16 columns again; req1_, req1000_: the first 26 and "
               "26,000 ids; d1f32_: the last column in f32 rows (LR's instance)", **gather,
    )
    got = gather_rows(table, gids, torch.bfloat16)  # the fanout's input

    # 2. split_fused_rows on the gathered rows [16384, 26, 17] bf16, then
    # the f32 xDeepFM path's f32 rows (f32_ keys); no single PyTorch call
    # computes both outputs, so the row has no library time
    fanout = {}
    for label, dt in (("", torch.bfloat16), ("f32_", torch.float32)):
        full = got if dt == torch.bfloat16 else gather_rows(table, gids, dt)
        x_dm, ws = split_fused_rows(full, DIM)
        x_ref, ws_ref = split_fused_rows_reference(full, DIM)
        check(torch.equal(x_dm, x_ref), f"split_fused_rows {dt} x_dm exact")
        err, scale = rel_err(ws, ws_ref)
        check(ws.shape == (BATCH,) and err <= F32_REL_TOL * max(scale, 1.0),
              f"split_fused_rows {dt} wide_sum {err} <= {F32_REL_TOL} * max(|ref|, 1)")
        x2, ws2 = split_fused_rows(full, DIM)
        check(torch.equal(x2, x_dm) and torch.equal(ws2, ws), f"split_fused_rows {dt} repeats bit for bit")
        b_ms, b_by = bound_ms(full.numel() * dt.itemsize + x_dm.numel() * dt.itemsize + ws.numel() * 4,
                              BATCH * m)
        fanout.update({f"{label}max_abs_err": err, f"{label}tol": F32_REL_TOL * max(scale, 1.0),
                       f"{label}bound_ms": b_ms, f"{label}bound_by": b_by})
        fanout.update(short_times(lambda: split_fused_rows(full, DIM),
                                  lambda: split_fused_rows_reference(full, DIM), prefix=label))
        del full, x_dm, ws, x_ref, ws_ref, x2, ws2
    report["split_fused_rows"] = dict(
        route="cuda", source="recmodels_tpu_torch/csrc/split_fused.cu",
        replaces="recmodels_tpu/ops/pallas/interactions_tpu.py:881", timing=SHORT_TIMING,
        library_none="two outputs (x_dm and wide_sum) that no single PyTorch call computes", **fanout,
    )

    # 3. cin2_forward: x0 [262144, 26] N(0, 1), the model's initial CIN weights
    x02 = torch.randn((BATCH * DIM, m), generator=gen, device=dev).to(torch.bfloat16)
    w1, w2 = (w.to(torch.bfloat16) for w in
              engine.model.init_dense(gen, dev)["cin_w"])
    h1, h2 = CIN
    outs = cin2_forward(x02, w1, w2, DIM, want_x1=True, want_q=True)
    refs = cin2_forward_reference(x02, w1, w2, DIM, want_x1=True, want_q=True)
    errs = []
    for name, o, r in zip(("x1", "p1", "p2", "Q"), outs, refs):
        err, scale = rel_err(o, r)
        print(f"cin2_forward {name}: max err {err:.6g}, max |ref| {scale:.6g}, "
              f"tol {BF16_REL_TOL * scale:.6g}")
        check(err <= BF16_REL_TOL * scale, f"cin2_forward {name} within {BF16_REL_TOL} of max |ref|")
        errs.append((err, BF16_REL_TOL * scale))
    _, p1, p2, _ = cin2_forward(x02, w1, w2, DIM)
    check(torch.equal(p1, outs[1]) and torch.equal(p2, outs[2]), "cin2_forward pools do not depend on want_x1/want_q")
    macs = cin_macs(BATCH * DIM, BATCH, m, h1, h2)[0]
    b_ms, b_by = bound_ms((x02.numel() + w1.numel() + w2.numel() + BATCH * (h1 + h2)) * 2, 2 * macs)
    report["cin2_forward"] = dict(
        route="cuda", source="recmodels_tpu_torch/csrc/cin2.cu",
        replaces="recmodels_tpu/ops/pallas/interactions_tpu.py:564",
        max_abs_err=max(e for e, _ in errs), tol=max(t for _, t in errs),
        ms=time_ms(lambda: cin2_forward(x02, w1, w2, DIM)),
        plain_ms=time_ms(lambda: cin2_forward_reference(x02, w1, w2, DIM), iters=5),
        library_ms=None, bound_ms=b_ms, bound_by=b_by,
        launch_ms=launch_split(lambda: cin2_forward(x02, w1, w2, DIM), calls=10),
        launch_ms_train=launch_split(lambda: cin2_forward(x02, w1, w2, DIM, want_x1=True, want_q=True),
                                     calls=10),
    )

    # 4. split_fused_rows_backward: g_dm [16384, 16, 26] bf16, g_ws [16384]
    # f32, then the same g_dm in f32 (f32_ keys: no new draws, so the later
    # phases see the generator where they always have); its library call is
    # one torch.cat
    fanout_bwd = {}
    g_dm_bf16 = torch.randn((BATCH, DIM, m), generator=gen, device=dev).to(torch.bfloat16)
    g_ws = torch.randn((BATCH,), generator=gen, device=dev)
    for label, dt in (("", torch.bfloat16), ("f32_", torch.float32)):
        g_dm = g_dm_bf16.to(dt)
        got = split_fused_rows_backward(g_dm, g_ws)
        check(torch.equal(got, split_fused_rows_backward_reference(g_dm, g_ws)),
              f"split_fused_rows_backward {dt} exact")
        check(torch.equal(split_fused_rows_backward(g_dm, g_ws), got),
              f"split_fused_rows_backward {dt} repeats bit for bit")
        library = lambda: torch.cat(  # noqa: E731
            (g_dm.transpose(1, 2), g_ws.to(g_dm.dtype)[:, None, None].expand(BATCH, m, 1)), 2)
        check(torch.equal(library(), got), f"split_fused_rows_backward {dt}: the library call computes the same")
        b_ms, b_by = bound_ms(g_dm.numel() * dt.itemsize + g_ws.numel() * 4 + got.numel() * dt.itemsize, 0.0)
        fanout_bwd.update({f"{label}max_abs_err": 0.0, f"{label}tol": 0.0,
                           f"{label}bound_ms": b_ms, f"{label}bound_by": b_by})
        fanout_bwd.update(short_times(lambda: split_fused_rows_backward(g_dm, g_ws),
                                      lambda: split_fused_rows_backward_reference(g_dm, g_ws),
                                      library, prefix=label))
        del g_dm, got
    del g_dm_bf16, g_ws
    report["split_fused_rows_backward"] = dict(
        route="cuda", source="recmodels_tpu_torch/csrc/split_fused.cu",
        replaces="recmodels_tpu/ops/pallas/interactions_tpu.py:939", timing=SHORT_TIMING, **fanout_bwd,
    )

    # 5. cin2_backward on the forward's x0, x1, Q and pool grads N(0, 1)
    x1, q = outs[0], outs[3]
    g1p = torch.randn((BATCH, h1), generator=gen, device=dev).to(torch.bfloat16)
    g2p = torch.randn((BATCH, h2), generator=gen, device=dev).to(torch.bfloat16)
    del outs, refs
    bwd = cin2_backward(x02, x1, w1, w2, q, g1p, g2p, DIM)
    ref = cin2_backward_reference(x02, x1, w1, w2, q, g1p, g2p, DIM)
    errs = []
    for name, o, r in zip(("gx0", "gw1", "gw2"), bwd, ref):
        err, scale = rel_err(o, r)
        print(f"cin2_backward {name}: max err {err:.6g}, max |ref| {scale:.6g}, "
              f"tol {BF16_REL_TOL * scale:.6g}")
        check(err <= BF16_REL_TOL * scale, f"cin2_backward {name} within {BF16_REL_TOL} of max |ref|")
        errs.append((err, BF16_REL_TOL * scale))
    check(all(torch.equal(a, b) for a, b in zip(bwd, cin2_backward(x02, x1, w1, w2, q, g1p, g2p, DIM))),
          "cin2_backward repeats bit for bit")
    del ref
    rows_ = BATCH * DIM
    macs = cin_macs(rows_, BATCH, m, h1, h2)[1]
    nbytes = (x02.numel() + x1.numel() + w1.numel() + w2.numel() + q.numel() + g1p.numel()
              + g2p.numel() + sum(t.numel() for t in bwd)) * 2
    b_ms, b_by = bound_ms(nbytes, 2 * macs)
    report["cin2_backward"] = dict(
        route="cuda", source="recmodels_tpu_torch/csrc/cin2_bwd.cu",
        replaces="recmodels_tpu/ops/pallas/interactions_tpu.py:658",
        max_abs_err=max(e for e, _ in errs), tol=max(t for _, t in errs),
        ms=time_ms(lambda: cin2_backward(x02, x1, w1, w2, q, g1p, g2p, DIM)),
        plain_ms=time_ms(lambda: cin2_backward_reference(x02, x1, w1, w2, q, g1p, g2p, DIM), iters=3),
        library_ms=None, bound_ms=b_ms, bound_by=b_by,
        launch_ms=launch_split(lambda: cin2_backward(x02, x1, w1, w2, q, g1p, g2p, DIM), calls=10),
    )
    cin2_padded_rows(report, x02, m, dev)
    for name in ("cin2_forward", "cin2_backward"):
        for label in ("", "w208_"):
            split = ", ".join(f"{k} {v:.4f}" for k, v in report[name][f"{label}launch_ms"].items())
            print(f"{name} {label or 'w128_'}launches by device time (ms a call): {split} on {card}")
    del bwd, x1, q, g1p, g2p, x02

    # 6. sorted_adagrad_update: the batch's sorted stream (425,984 ids) into
    # the 2,600,960 x 17 table, bf16 grads N(0, 0.01); then a dim-1 table;
    # lr read by the kernel from device memory. Two instances derive from
    # these draws (no new ones): PNN's 16-column table (d16_: the first 16
    # columns of table, acc and grads) and LR's f32 grads on the dim-1 table
    # (dim1_f32_)
    sorted_ids, _, _ = slot_sorted_ids(gids)
    n = sorted_ids.numel()
    lr, eps = 1e-2, 1e-8
    lr_t = torch.tensor(lr, device=dev)
    update = {}

    def adagrad_instance(label, upd_table, upd_acc, grads):
        d1 = upd_table.shape[1] if upd_table.dim() > 1 else 1
        t_cpu, a_cpu = upd_table.cpu(), upd_acc.cpu()
        sorted_adagrad_update_reference(t_cpu, a_cpu, sorted_ids.cpu(), grads.cpu(), lr_t.cpu(), eps)
        sorted_adagrad_update(upd_table, upd_acc, sorted_ids, grads, lr_t, eps)
        torch.cuda.synchronize()
        err = max((upd_table.cpu() - t_cpu).abs().max().item(), (upd_acc.cpu() - a_cpu).abs().max().item())
        check(err == 0.0, f"sorted_adagrad_update {label or 'd17 '}bit-exact against the CPU plain version ({err})")
        touched = torch.unique(sorted_ids).numel()
        b_ms, b_by = bound_ms(n * 4 + grads.numel() * grads.element_size() + touched * d1 * 4 * 4, 0.0)
        # each touched sector of the table and acc read once and written once
        sectors = (range_sectors(sorted_ids) + range_sectors(grads)
                   + 2 * (row_sectors(upd_table, sorted_ids) + row_sectors(upd_acc, sorted_ids)))
        update.update({f"{label}max_abs_err": err, f"{label}bound_ms": b_ms, f"{label}bound_by": b_by,
                       f"{label}sector_bound_ms": sector_bound_ms(sectors)})
        kernel = lambda: sorted_adagrad_update(upd_table, upd_acc, sorted_ids, grads, lr_t, eps)  # noqa: E731
        plain = lambda: sorted_adagrad_update_reference(  # noqa: E731
            upd_table, upd_acc, sorted_ids, grads, lr_t, eps)
        library = adagrad_library_step(upd_table, sorted_ids, grads, lr, eps)
        update.update(short_times(kernel, plain, library, label))

    for label, d1 in (("", DIM + 1), ("dim1_", 1)):
        shape = (rows, d1) if d1 > 1 else (rows,)
        upd_table = table.clone() if d1 > 1 else table[:, -1].contiguous()
        upd_acc = torch.full(shape, 0.1, device=dev) + torch.rand(shape, generator=gen, device=dev)
        grads = (torch.randn((n, *shape[1:]), generator=gen, device=dev) * 0.01).to(torch.bfloat16)
        derived = (("d16_", upd_table[:, :DIM].contiguous(), upd_acc[:, :DIM].contiguous(),
                    grads[:, :DIM].contiguous()) if d1 > 1 else
                   ("dim1_f32_", upd_table.clone(), upd_acc.clone(), grads.float()))
        adagrad_instance(label, upd_table, upd_acc, grads)
        adagrad_instance(*derived)
        del upd_table, upd_acc, grads, derived
    report["sorted_adagrad_update"] = dict(
        route="cuda", source="recmodels_tpu_torch/csrc/adagrad_update.cu",
        replaces="recmodels_tpu/embedding/pallas_update.py:427",
        also_replaces="recmodels_tpu/embedding/pallas_update.py:296 (the dim1_ and dim1_f32_ keys)",
        shapes="unprefixed keys: 425,984 sorted ids into 2,600,960 x 17, bf16 grads; d16_: its first 16 "
               "columns (PNN's table); dim1_: a [2,600,960] table, bf16 grads; dim1_f32_: the same with f32 "
               "grads (LR's table)",
        timing=SHORT_TIMING,
        tol=0.0, **update,
    )
    del table
    cfg3 = TrainConfig(model="xdeepfm", bf16=True, vocab_size=VOCAB, embed_dim=DIM,
                       cin_sizes=CIN3, hidden=HIDDEN, batch_size=BATCH, seed=SEED)
    engine3 = Engine(build_model(cfg3.model, schema, **cfg3.model_kwargs()), dense_lr=1e-3,
                     emb_lr=1e-2, sparse_optimizer="adam", fuse_wide=False)
    slice3_kernels(report, engine3, ids, card, gen)
    slice4_kernels(report, card, gen)
    for name, r in report.items():
        for pre in sorted({k[: -len("plain_ms")] for k in r if k.endswith("plain_ms")}):
            lib = r[pre + "library_ms"]
            tol = f" (tol {r[pre + 'tol']:.6g})" if pre + "tol" in r else ""
            warm = "".join(f", {what} warm {r[pre + key]:.4f} ms" for what, key in (
                ("kernel", "warm_ms"), ("plain", "plain_warm_ms"), ("library", "library_warm_ms"))
                if r.get(pre + key) is not None)
            sector = (f", sector bound {r[pre + 'sector_bound_ms']:.4f} ms"
                      if pre + "sector_bound_ms" in r else "")
            print(f"{name}{' ' + pre[:-1] if pre else ''}: max err {r[pre + 'max_abs_err']:.6g}{tol}; kernel "
                  f"{r[pre + 'ms']:.4f} ms, plain {r[pre + 'plain_ms']:.4f} ms, library "
                  f"{'-' if lib is None else format(lib, '.4f') + ' ms'}{warm}, bound "
                  f"{r[pre + 'bound_ms']:.4f} ms ({r[pre + 'bound_by']}){sector} on {card}")

    # -------------------------------------------------------------- serving
    serving_phase("full-width bf16 xDeepFM", cfg, engine, (gather_rows, split_fused_rows, cin2_forward),
                  term_sizes, batch.dense, batch.ids, card, gen)
    launches = training_phase(
        "full-width bf16 xDeepFM, Adam 1e-3 + sparse Adagrad 1e-2", engine, schema, BATCH,
        (gather_rows, split_fused_rows, cin2_forward, sorted_adagrad_update, split_fused_rows_backward,
         cin2_backward), 11, card, gen, scan=True, evaluate=True)
    launches3 = training3_phase(engine3, schema, card, gen)
    adam_dense_check(engine3, ids, card, gen)
    paths = {"slice2": launches, "slice3": launches3}

    # -------------------------------------------- slice 4, then f32 xDeepFM
    # each: (path, model, title, batch, bf16, model kwargs, the serving path's
    # kernels, the training step's kernels, the term check, stream seed, rows'
    # scale); f32 xDeepFM is bench.py --no-bf16: its CIN runs layer by layer
    # through the layer kernel (two launches a step and a request), its
    # backward through the f32 einsums
    slice4 = (
        ("deepfm", "deepfm", f"full-width bf16 DeepFM, DNN{DEEPFM_HIDDEN}", BATCH, True,
         dict(hidden=DEEPFM_HIDDEN), (gather_rows, fm_pairwise_forward),
         (gather_rows, fm_pairwise_forward, sorted_adagrad_update), fm_term_sizes, 17, 3.0),
        ("dcn", "dcn", f"full-width bf16 DCN, {N_CROSS} cross layers over 429, DNN{DCN_HIDDEN}", BATCH, True,
         dict(hidden=DCN_HIDDEN, n_cross=N_CROSS), (gather_rows, dcn_cross_stack_forward),
         (gather_rows, dcn_cross_stack_forward, sorted_adagrad_update), cross_term_sizes, 19, 10.0),
        ("fm", "fm", "full-width f32 FM", FM_BATCH, False, {}, (gather_rows, fm_pairwise_forward),
         (gather_rows, fm_pairwise_forward, sorted_adagrad_update), fm_term_sizes, 23, 3.0),
        ("xdeepfm_f32", "xdeepfm", f"full-width f32 xDeepFM, CIN{CIN}, DNN{HIDDEN}", BATCH, False,
         dict(cin_sizes=CIN, hidden=HIDDEN), (gather_rows, split_fused_rows, cin_layer_forward),
         (gather_rows, split_fused_rows, cin_layer_forward, sorted_adagrad_update, split_fused_rows_backward),
         term_sizes, 29, 10.0),
    )
    for path, model, title, n, bf16, kw, serve_kernels, train_kernels, terms, seed, rows_scale in slice4:
        cfg4 = TrainConfig(model=model, bf16=bf16, vocab_size=VOCAB, embed_dim=DIM, batch_size=n,
                           seed=SEED, **kw)
        engine4 = Engine(build_model(model, schema, **cfg4.model_kwargs()))
        serving_phase(title, cfg4, engine4, serve_kernels, terms, batch.dense[:n], batch.ids[:n],
                      card, gen, rows_scale)
        paths[path] = training_phase(f"{title}, Adam 1e-3 + sparse Adagrad 1e-2", engine4, schema, n,
                                     train_kernels, seed, card, gen, rows_scale)
    repaired_shapes_phase(card, gen)

    # ------------------------------- slice 6: LR, PNN, Wide&Deep, NFM, AFM
    # each: (path, title, bf16, TrainConfig kwargs, stream seed, rows'
    # scale) at bench.py's widths and BATCH; each serves through the gather
    # (#1) and trains through the gather and the sparse Adagrad update (#4;
    # #8 on LR's dim-1 table)
    zoo = (
        ("lr", "full-width f32 LR", False, {}, 41, 10.0),
        ("pnn", f"full-width bf16 PNN (inner and outer), DNN{PNN_HIDDEN}", True,
         dict(pnn_mode="both", hidden=PNN_HIDDEN), 43, 3.0),
        ("widedeep", f"full-width bf16 Wide&Deep, DNN{WIDEDEEP_HIDDEN}", True, dict(hidden=WIDEDEEP_HIDDEN), 47,
         10.0),
        ("nfm", f"full-width bf16 NFM, DNN{NFM_HIDDEN}", True, dict(hidden=NFM_HIDDEN), 53, 3.0),
        ("afm", f"full-width bf16 AFM, attention {AFM_ATTENTION}", True, dict(attention_dim=AFM_ATTENTION), 59,
         10.0),
    )
    for path, title, bf16, kw, seed, rows_scale in zoo:
        cfg6 = TrainConfig(model=path, bf16=bf16, vocab_size=VOCAB, embed_dim=DIM, batch_size=BATCH,
                           seed=SEED, **kw)
        engine6 = Engine(build_model(path, schema, **cfg6.model_kwargs()))
        serving_phase(title, cfg6, engine6, (gather_rows,), zoo_term_sizes, batch.dense, batch.ids, card, gen,
                      rows_scale)
        paths[path] = training_phase(f"{title}, Adam 1e-3 + sparse Adagrad 1e-2", engine6, schema, BATCH,
                                     (gather_rows, sorted_adagrad_update), seed, card, gen, rows_scale)
    launched = paths["xdeepfm_f32"]["cin_layer_forward"]
    check(launched == 2 * TRAIN_STEPS,
          f"cin_layer_forward launched twice a step on the f32 xDeepFM path ({launched} in {TRAIN_STEPS} steps)")

    # ------------------------- slice 7: the training entry point, phases g-j
    with tempfile.TemporaryDirectory(prefix="chip-smoke-") as work:
        step_kernels = (gather_rows, split_fused_rows, cin2_forward, sorted_adagrad_update,
                        split_fused_rows_backward, cin2_backward)
        loop_ckpt, host_sustained, loop_c_ms = watched(loop_phase, work, step_kernels, card)
        watched(resume_phase, work, card)
        watched(compiled_steps_phase, schema, card)
        watched(export_predict_phase, work, loop_ckpt, card)

        # -------------------------- slice 8: in-graph data generation, phase k
        report["synth_batch"], paths["device_synth"] = watched(
            generation_phase, work, schema, step_kernels, card, host_sustained, loop_c_ms)

    # ----- slices 9-10: an NCCL world of one, formed by multihost.initialize
    import socket

    import torch.distributed as dist

    from recmodels_tpu_torch.parallel import multihost

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    multihost.initialize(f"127.0.0.1:{port}", 1, 0)
    check(dist.get_backend() == "nccl" and dist.get_world_size() == 1 and multihost.host_shard() == (0, 1),
          "multihost.initialize formed an NCCL world of one")
    try:
        paths["sharded"], paths["sharded3"] = watched(sharded_phase, engine, engine3, schema, report, card)
        with tempfile.TemporaryDirectory(prefix="chip-smoke-") as work:
            paths["sharded_restored"] = watched(multihost_phase, engine, schema, work, card)
    finally:
        dist.destroy_process_group()
    watched(graft_phase, card)
    watched(bag_gather_phase, card)

    # each kernel's launches come from the first path in this order that
    # runs it (slice 2's for the six kernels of the xDeepFM step, slice 3's
    # for lazy Adam, the CIN layer and the transpose, DeepFM's for
    # fm_pairwise_forward, DCN's for dcn_cross_stack_forward); every path's
    # count is listed beside them (launches_xdeepfm_f32: the f32 xDeepFM
    # step's; launches_lr: LR's, whose sorted_adagrad_update count is #8's,
    # the dim-1 instance)
    main_keys = ("route", "source", "replaces", "max_abs_err", "ms", "plain_ms", "bound_ms",
                 "bound_by", "library_ms")
    kernel_rows = []
    for name, r in report.items():
        path = next((p for p in paths if paths[p].get(name, 0) > 0), None)
        check(path is not None, f"{name} launched on a training path")
        kernel_rows.append(
            {"name": name, **{k: r[k] for k in main_keys[:3]}, "launches": paths[path][name],
             **{k: r[k] for k in main_keys[3:]}, "launches_from": path,
             **{f"launches_{p}": c.get(name, 0) for p, c in paths.items()},
             **{k: v for k, v in r.items() if k not in main_keys and k != "tol"}})
    print(json.dumps({"kernels": kernel_rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


# ----------------------------------------- pooled bags (DLRM-DCNv2)
def bag_gather_phase(card: str, seed: int = 1) -> dict:
    """The pooled bag gather (``csrc/bag_gather.cu``) and #4 at d = 128 on
    one batch of the benchmark's DLRM-DCNv2 cell (``benchmark/configs/
    dlrm-dcnv2-criteo1tb.json``: 16,384 examples, 214 ids in 26 bags, a
    51,883,621 x 128 f32 table; ids from the cell's generator): each against
    its plain version (bits), timed by CUDA events over back-to-back calls
    and by torch.profiler; the gather beside the library's
    ``torch.nn.functional.embedding_bag(mode="sum")`` with its cast to bf16,
    and its byte bound (distinct rows, ids, the pooled bf16 output). #4 both
    ways: on the expanded stream (the pooled grads' ``index_select`` along
    the sorted bags, then #4) and on the pooled grads read through the bags
    (``grad_index``), the two from one state bit for bit, each beside #4's
    byte bound. Run it alone with ``python -c "import chip_smoke as c;
    c.bag_gather_phase(c.card_line())"``."""
    import torch.nn.functional as F

    from benchmark import counts, counts_dcnv2
    from benchmark.gen import multihot, zipf
    from recmodels_tpu_torch.embedding.bag import bag_gather, bag_gather_reference
    from recmodels_tpu_torch.embedding.optim import bag_sorted_ids
    from recmodels_tpu_torch.embedding.update import sorted_adagrad_update, sorted_adagrad_update_reference

    print("== pooled bag gather and #4 at the DLRM-DCNv2 cell's shapes")
    cell = "dlrm-dcnv2-criteo1tb.train-zipf"
    cfg = json.load(open(os.path.join(ROOT, "benchmark", "configs", "dlrm-dcnv2-criteo1tb.json")))
    params = json.load(open(os.path.join(ROOT, "benchmark", "workloads", f"{cell}.json")))["params"]
    dev = torch.device("cuda")
    b, hot, d = cfg["batch_size"], tuple(cfg["hotness"]), cfg["embed_dim"]
    slots = multihot.slots_for(cfg, params, seed, dev)
    _, ids, _ = multihot.batch_pool(slots, 1, b, cfg["n_dense"], params, zipf.generator(seed, dev, 5))
    del slots
    off = multihot.slot_offsets(cfg)
    cols = torch.tensor([off[s] for s, h in enumerate(hot) for _ in range(h)], dtype=torch.int32, device=dev)
    gids = (ids[0] + cols).contiguous()
    n_rows = multihot.n_rows(cfg)
    table = torch.empty((n_rows, d), device=dev).normal_(generator=torch.Generator(dev).manual_seed(seed))
    got = bag_gather(table, gids, hot, torch.bfloat16)
    check(torch.equal(got, bag_gather_reference(table, gids, hot, torch.bfloat16)),
          "bag_gather bit for bit its plain version at the cell's shapes")
    first = torch.tensor([sum(hot[:s]) for s in range(len(hot))], device=dev)
    bag_starts = (torch.arange(b, device=dev)[:, None] * sum(hot) + first).reshape(-1)
    flat = gids.reshape(-1).long()
    library = lambda: F.embedding_bag(flat, table, bag_starts, mode="sum").to(torch.bfloat16)  # noqa: E731
    lib = library().reshape(b, len(hot), d).float()
    err = float((lib - got.float()).abs().max() / got.float().abs().max())
    unique = int(torch.unique(gids).numel())
    nbytes = counts_dcnv2.bag_gather_bytes(unique, gids.numel(), b * len(hot), d)
    row = {"shapes": f"B = {b}, {gids.numel()} ids in {len(hot)} bags, {unique} distinct rows, table "
                     f"{n_rows} x {d} f32, bf16 out",
           "ms": time_ms(lambda: bag_gather(table, gids, hot, torch.bfloat16)),
           "warm_ms": device_ms(lambda: bag_gather(table, gids, hot, torch.bfloat16)),
           "plain_ms": time_ms(lambda: bag_gather_reference(table, gids, hot, torch.bfloat16), iters=5),
           "library_ms": time_ms(library), "library_warm_ms": device_ms(library),
           "library_rel_err": err, "bound_ms": counts.bound_ms(torch.cuda.get_device_name(0), nbytes=nbytes)}
    sorted_ids, bags = bag_sorted_ids(gids, hot)
    pooled = torch.randn((b * len(hot), d), device=dev).to(torch.bfloat16)
    expand = lambda: pooled.index_select(0, bags)  # noqa: E731
    grads = expand()
    acc = torch.full_like(table, 0.1)
    lr = torch.tensor(0.005, device=dev)
    # the plain version sums in stream order on the CPU (index_add_ on the
    # card adds by atomics, in no fixed order): the touched rows alone there
    uids = torch.unique(sorted_ids.long())
    t0, a0 = table[uids], acc[uids]
    sub_t, sub_a = t0.cpu(), a0.cpu()
    sorted_adagrad_update_reference(sub_t, sub_a, torch.searchsorted(uids, sorted_ids.long()).int().cpu(),
                                    grads.cpu(), lr.cpu(), 1e-8)
    sorted_adagrad_update(table, acc, sorted_ids, grads, lr, 1e-8)
    check(torch.equal(table[uids].cpu(), sub_t) and torch.equal(acc[uids].cpu(), sub_a),
          "#4 at d = 128 bit for bit its plain version")
    # the pooled route from the same state (only the touched rows move)
    table[uids], acc[uids] = t0, a0
    del t0, a0
    sorted_adagrad_update(table, acc, sorted_ids, pooled, lr, 1e-8, bags)
    check(torch.equal(table[uids].cpu(), sub_t) and torch.equal(acc[uids].cpu(), sub_a),
          "#4 on the pooled grads bit for bit the expanded stream's update")
    del sub_t, sub_a
    update = lambda: sorted_adagrad_update(table, acc, sorted_ids, grads, lr, 1e-8)  # noqa: E731
    pooled_update = lambda: sorted_adagrad_update(table, acc, sorted_ids, pooled, lr, 1e-8, bags)  # noqa: E731
    expand_update = lambda: sorted_adagrad_update(table, acc, sorted_ids, expand(), lr, 1e-8)  # noqa: E731
    row.update(update_ms=time_ms(update), update_warm_ms=device_ms(update),
               pooled_update_ms=time_ms(pooled_update), pooled_update_warm_ms=device_ms(pooled_update),
               expand_ms=time_ms(expand), expand_warm_ms=device_ms(expand),
               expand_update_ms=time_ms(expand_update), expand_update_warm_ms=device_ms(expand_update),
               update_plain_ms=time_ms(lambda: sorted_adagrad_update_reference(table, acc, sorted_ids, grads, lr,
                                                                                1e-8), iters=3),
               update_bound_ms=counts.bound_ms(torch.cuda.get_device_name(0),
                                               nbytes=counts.adagrad_update_bytes(unique, sorted_ids.numel(), d)))
    print(json.dumps({"bag_gather": row}))
    print(card)
    del table, acc, grads, pooled
    torch.cuda.empty_cache()
    return row


# --------------------------------------------- slice 7: the entry point
class _Tee:
    """A stream that writes to two."""

    def __init__(self, *streams):
        self.streams = streams

    def write(self, text):
        for st in self.streams:
            st.write(text)
        return len(text)

    def flush(self):
        for st in self.streams:
            st.flush()


def watched(phase, *args):
    """``phase(*args)``; if it is still running after PHASE_LIMIT_S seconds,
    every thread's stack goes to stderr and the process exits non-zero."""
    faulthandler.dump_traceback_later(PHASE_LIMIT_S, exit=True)
    try:
        return phase(*args)
    finally:
        faulthandler.cancel_dump_traceback_later()


def run_cli(main, argv: list[str]) -> str:
    """Run a CLI's ``main(argv)`` in this process, its output shown and
    returned; fails unless it returns 0."""
    import contextlib
    import io

    print("$ python -m " + main.__module__ + " " + " ".join(argv))
    out = io.StringIO()
    with contextlib.redirect_stdout(_Tee(sys.stdout, out)):
        rc = main(argv)
    check(rc == 0, f"{main.__module__} returned {rc}")
    return out.getvalue()


def flagship_args(batch: int | None = None) -> list[str]:
    """The flagship's flags (bench.py:72): bf16 xDeepFM, 26 slots x 1e5 ids,
    dim 16 plus the fused wide column, CIN(128,128), DNN(400,400), dense Adam
    1e-3 and sparse Adagrad 1e-2 (TrainConfig's defaults), seed SEED."""
    return ["--model", "xdeepfm", "--batch-size", str(batch or BATCH), "--set", "bf16=True",
            "--set", f"vocab_size={VOCAB}", "--set", f"embed_dim={DIM}", "--set", f"cin_sizes={CIN}",
            "--set", f"hidden={HIDDEN}", "--set", f"seed={SEED}"]


def logged(out: str, kind: str) -> list[tuple[int, dict]]:
    """(step, scalars) of each ``step N <kind> {...}`` line a logger wrote."""
    import re

    return [(int(m.group(1)), json.loads(m.group(2)))
            for m in re.finditer(rf"step +(\d+) {kind} (\{{.*\}})", out)]


def trace_busy(path: str) -> tuple[float, float]:
    """(device busy ms, window ms) of a torch.profiler Chrome trace: the union
    of the card's kernel, copy and set spans, and the span of every event."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X" and "dur" in e]
    window = (max(e["ts"] + e["dur"] for e in events) - min(e["ts"] for e in events)) / 1e3
    busy, end = 0.0, None
    for start, stop in sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")):
        if end is None or start > end:
            busy += stop - start
            end = stop
        elif stop > end:
            busy += stop - end
            end = stop
    return busy / 1e3, window


def saved_tensors(path: str) -> list[tuple[str, torch.Tensor]]:
    """(path, tensor) of every tensor a checkpoint's state.pt holds."""
    return list(named_tensors(torch.load(path, map_location="cpu", weights_only=True)))


def loop_phase(work: str, kernels, card: str) -> str:
    """(g) ``cli.train.main`` trains the flagship LOOP_STEPS steps through the
    port's Trainer: superbatches of LOOP_SCAN (``jit_train_scan``), a cosine
    schedule with LOOP_WARMUP warmup steps on both lrs, adamw's decay,
    checkpoints every LOOP_CKPT_EVERY, eval of LOOP_EVAL_BATCHES held-out
    batches at the end, the producer pool at its default size and a
    torch.profiler trace of superbatches 2-4. Every kernel of the step must
    launch inside the Trainer (the wrappers count the eager warm-up and the
    capture), the last logged loss must be below the first, val AUC and
    logloss finite, and checkpoints 20, 40 and 60 on disk. Prints the
    loop's examples/s per log interval, the sustained rate of a
    SUSTAIN_STEPS-step run without checkpoints, eval or trace, and the
    producer pool's rate alone, beside (c') of the same configuration
    (jit_train_step, events); the card's busy share over the traced window;
    and the ms to save and restore one full-width checkpoint. Returns the
    checkpoint directory, the sustained examples/s and (c') in ms."""
    from recmodels_tpu_torch.cli import train as train_cli
    from recmodels_tpu_torch.data import SyntheticSource
    from recmodels_tpu_torch.train.checkpoint import CheckpointManager
    from recmodels_tpu_torch.train.loop import Trainer, make_producer_pool
    from recmodels_tpu_torch.utils.config import TrainConfig, build_schema

    print(f"== the loop (g): cli.train, full-width bf16 xDeepFM, {LOOP_STEPS} steps at {BATCH}")
    ckpt, trace_dir = os.path.join(work, "loop"), os.path.join(work, "loop-trace")
    argv = flagship_args() + [
        "--steps", str(LOOP_STEPS), "--ckpt-dir", ckpt, "--profile-dir", trace_dir,
        "--set", f"scan_steps={LOOP_SCAN}", "--set", "log_every=10", "--set", "lr_schedule='cosine'",
        "--set", f"warmup_steps={LOOP_WARMUP}", "--set", f"dense_weight_decay={LOOP_DECAY}",
        "--set", f"eval_every={LOOP_STEPS}", "--set", f"eval_batches={LOOP_EVAL_BATCHES}",
        "--set", f"ckpt_every={LOOP_CKPT_EVERY}"]
    torch.cuda.synchronize()
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    out = run_cli(train_cli.main, argv)
    wall = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in kernels}
    print(f"launches inside the Trainer (eager warm-ups and captures; replays are not counted): {launches}")
    for name, count in launches.items():
        check(count > 0, f"{name} launched inside the Trainer")
    train, val = logged(out, "train"), logged(out, "val")
    check([s for s, _ in train] == list(range(10, LOOP_STEPS + 1, 10)), "a train line every 10 steps")
    check(train[-1][1]["loss"] < train[0][1]["loss"],
          f"the last logged loss ({train[-1][1]['loss']}) is below the first ({train[0][1]['loss']})")
    check(len(val) == 1 and all(np.isfinite(val[0][1][k]) for k in ("auc", "logloss")),
          f"finite val AUC and logloss ({val})")
    steps = sorted(int(d) for d in os.listdir(ckpt) if d.isdigit())
    check(steps == [20, 40, 60], f"checkpoints 20, 40 and 60 on disk ({steps})")
    print(f"val at step {val[0][0]}: AUC {val[0][1]['auc']}, logloss {val[0][1]['logloss']}")

    # what each log interval held: the save at 10 (the first) and at 20 and
    # 40 fall in the intervals that end 10 steps later; the trace covers
    # superbatches 2-4 (steps 20-50); 50-60 holds steps alone
    held = {10: "warm-up, capture", 20: "save of 10", 30: "save of 20, trace", 40: "trace",
            50: "save of 40, trace", 60: "steps only"}
    for step, scalars in train:
        print(f"loop examples/s, steps {step - 10}-{step} ({held.get(step, '')}): "
              f"{scalars['examples_per_sec']:.1f} on {card}")
    print(f"loop, the whole cli.train run ({LOOP_STEPS} steps, start-up, eval and checkpoints included): "
          f"{wall:.3f} s, {LOOP_STEPS * BATCH / wall:.1f} examples/s on {card}")
    busy, window = trace_busy(os.path.join(trace_dir, "trace.json"))
    print(f"loop, superbatches 2-4 (torch.profiler): the card busy {busy:.3f} ms of a {window:.3f} ms window "
          f"({busy / window:.1%}) on {card}")

    # the intervals above hold what a checkpoint or the trace stalled; the
    # producer fills its queue meanwhile, so an interval after a stall can
    # run on prefetched superbatches. The sustained rate: a run without
    # checkpoints, eval or trace, its intervals from SUSTAIN_FROM on
    sustain = run_cli(train_cli.main, flagship_args() + [
        "--steps", str(SUSTAIN_STEPS), "--set", f"scan_steps={LOOP_SCAN}", "--set", "log_every=10",
        "--set", "eval_every=0"])
    rates = [sc["examples_per_sec"] for step, sc in logged(sustain, "train") if step > SUSTAIN_FROM]
    check(len(rates) == (SUSTAIN_STEPS - SUSTAIN_FROM) // 10, "a train line every 10 steps of the sustained run")
    sustained = float(np.median(rates))
    print(f"loop, sustained ({SUSTAIN_STEPS} steps, no checkpoint, eval or trace; the intervals after step "
          f"{SUSTAIN_FROM}): median {sustained:.1f} examples/s (min {min(rates):.1f}, max {max(rates):.1f}) on {card}")

    cfg = TrainConfig.from_json(open(os.path.join(ckpt, "config.json")).read())
    src = SyntheticSource(build_schema(cfg), batch_size=BATCH, seed=cfg.seed)
    workers = min(8, (os.cpu_count() or 4) // 2)
    pool = make_producer_pool(src, workers, range(workers + 40))
    try:
        for _ in range(workers):  # the workers up
            next(pool)
        t0 = time.perf_counter()
        for _ in range(40):
            next(pool)
        made = 40 * BATCH / (time.perf_counter() - t0)
    finally:
        pool.close()
    print(f"the producer pool alone ({workers} workers on {os.cpu_count()} host cores, 40 batches of {BATCH}): "
          f"{made:.1f} examples/s, on the host of {card}")

    trainer = Trainer(cfg.apply_overrides(["ckpt_dir=None"]))
    state = trainer.engine.init(seed=cfg.seed, device=trainer.device)
    b = next(iter(SyntheticSource(trainer.schema, batch_size=BATCH, seed=71)))
    dense, ids, labels = (torch.as_tensor(a, device="cuda") for a in (b.dense, b.ids, b.labels))
    step_ms = time_ms(lambda: trainer.train_step(state, dense, ids, labels), iters=10)
    print(f"(c') of the loop's configuration (jit_train_step with the schedules and decay, CUDA events, 10 "
          f"calls): {step_ms:.4f} ms per step, {BATCH / step_ms * 1e3:.1f} examples/s; the sustained loop "
          f"reaches {sustained / (BATCH / step_ms * 1e3):.1%} of it, on {card}")

    mgr = CheckpointManager(os.path.join(work, "timing"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mgr.save(1, state)
    t_copy = time.perf_counter()
    mgr.wait()
    t_write = time.perf_counter()
    mgr.restore(state)
    torch.cuda.synchronize()
    t_restore = time.perf_counter()
    size = sum(os.path.getsize(os.path.join(work, "timing", "1", f)) for f in os.listdir(os.path.join(work, "timing", "1")))
    print(f"one full-width checkpoint ({size / 2**20:.1f} MiB): save {1e3 * (t_copy - t0):.1f} ms to copy to "
          f"the host + {1e3 * (t_write - t_copy):.1f} ms to write (background), restore "
          f"{1e3 * (t_restore - t_write):.1f} ms, on {card}")
    del trainer, state
    return ckpt, sustained, step_ms


def resume_phase(work: str, card: str) -> None:
    """(h) cli.train: run A trains RESUME_STEPS steps straight; run B trains
    half of them, then a new run resumes B's directory to RESUME_STEPS
    (constant lr, adamw decay, superbatches of 10, checkpoints every 10):
    every tensor of the two final checkpoints equal bit for bit."""
    from recmodels_tpu_torch.cli import train as train_cli

    print(f"== resume (h): {RESUME_STEPS} steps straight against {RESUME_STEPS // 2} and a resume")
    common = flagship_args() + ["--set", f"scan_steps={LOOP_SCAN}", "--set", "ckpt_every=10", "--set", "eval_every=0",
                                "--set", f"dense_weight_decay={LOOP_DECAY}", "--set", "log_every=10"]
    a, b = os.path.join(work, "resume-a"), os.path.join(work, "resume-b")
    t0 = time.perf_counter()
    run_cli(train_cli.main, common + ["--steps", str(RESUME_STEPS), "--ckpt-dir", a])
    run_cli(train_cli.main, common + ["--steps", str(RESUME_STEPS // 2), "--ckpt-dir", b])
    out = run_cli(train_cli.main, common + ["--steps", str(RESUME_STEPS), "--ckpt-dir", b])
    check(f"resumed from checkpoint at step {RESUME_STEPS // 2}" in out, "the third run resumed at the half")
    ta = saved_tensors(os.path.join(a, str(RESUME_STEPS), "state.pt"))
    tb = saved_tensors(os.path.join(b, str(RESUME_STEPS), "state.pt"))
    check([n for n, _ in ta] == [n for n, _ in tb], "the two final states hold the same tensors")
    differ = [n for (n, x), (_, y) in zip(ta, tb) if not torch.equal(x, y)]
    check(not differ, f"resumed run bit for bit the straight one (differ: {differ[:5]})")
    print(f"resume: all {len(ta)} tensors of the two step-{RESUME_STEPS} states equal bit for bit "
          f"({time.perf_counter() - t0:.3f} s for the three runs) on {card}")


def compiled_steps_phase(schema, card: str) -> None:
    """(i) On the flagship: ``jit_train_step_accum`` with A = 2 (two
    micro-batches of BATCH / 2) for ACCUM_STEPS steps in lockstep with eager
    ``train_step_accum``, then SCHED_STEPS ``jit_train_step``s on a cosine
    schedule with warmup (both lrs change every step) with adamw's decay in
    lockstep with eager ``train_step``: every loss and every state tensor
    must agree bit for bit after every step. Prints the accumulated step's
    captured ms (CUDA events, 10 calls)."""
    from recmodels_tpu_torch.data import SyntheticSource
    from recmodels_tpu_torch.models import build_model
    from recmodels_tpu_torch.train.engine import Engine
    from recmodels_tpu_torch.train.schedules import build_lr_schedule
    from recmodels_tpu_torch.utils.config import TrainConfig

    print("== compiled steps (i): the accumulated and the scheduled step, captured against eager")
    dev = torch.device("cuda")
    cfg = TrainConfig(model="xdeepfm", bf16=True, vocab_size=VOCAB, embed_dim=DIM, cin_sizes=CIN, hidden=HIDDEN)
    src = iter(SyntheticSource(schema, batch_size=BATCH, seed=67))
    batches = [tuple(torch.as_tensor(a, device=dev) for a in (b.dense, b.ids, b.labels))
               for b in (next(src) for _ in range(ACCUM_STEPS))]

    def lockstep(title, engine, eager_step, captured_step, batches) -> None:
        eager = engine.init(seed=SEED, device=dev)
        captured = to_device(eager, dev)
        for k, batch in enumerate(batches):
            eager, me = eager_step(eager, *batch)
            captured, mc = captured_step(captured, *batch)
            check(torch.equal(me["loss"], mc["loss"]), f"{title}: step {k}'s loss bit for bit")
            for (name, x), (_, y) in zip(named_tensors(eager), named_tensors(captured)):
                check(torch.equal(x, y), f"{title}: {name} bit for bit after step {k}")
        check(captured_step.graphs == 1, f"{title}: one graph captured ({captured_step.graphs})")
        print(f"{title}: captured and eager agree bit for bit over {len(batches)} steps (every loss and "
              f"every state tensor after every step) on {card}")

    engine = Engine(build_model("xdeepfm", schema, **cfg.model_kwargs()))
    micro = [tuple(t.reshape(2, BATCH // 2, *t.shape[1:]) for t in b) for b in batches]
    ts = engine.jit_train_step_accum()
    lockstep("jit_train_step_accum, A = 2", engine, engine.train_step_accum, ts, micro)
    state = engine.init(seed=SEED, device=dev)
    accum_ms = time_ms(lambda: ts(state, *micro[-1]), iters=10)
    print(f"captured accumulated step (2 x {BATCH // 2}): {accum_ms:.4f} ms per step (CUDA events, 10 calls), "
          f"{BATCH / accum_ms * 1e3:.1f} examples/s on {card}")
    del state

    sched = dict(kind="cosine", warmup_steps=LOOP_WARMUP, total_steps=SCHED_STEPS)
    engine = Engine(build_model("xdeepfm", schema, **cfg.model_kwargs()),
                    dense_lr_schedule=build_lr_schedule(1e-3, **sched),
                    emb_lr_schedule=build_lr_schedule(1e-2, **sched), dense_weight_decay=LOOP_DECAY)
    lockstep(f"jit_train_step on a cosine schedule with {LOOP_WARMUP} warmup steps", engine, engine.train_step,
             engine.jit_train_step(), [batches[k % len(batches)] for k in range(SCHED_STEPS)])


def export_predict_phase(work: str, loop_ckpt: str, card: str) -> None:
    """(j) cli.export writes the artifact of the loop's last checkpoint and
    cli.predict scores two synthetic batches with it: each probability
    within 1/4 of the serving tolerance (LOGIT_REL_TOL of max |logit|;
    sigmoid moves by at most a quarter of its argument's change) plus the
    printed digits of sigmoid(Engine.logits) of the restored checkpoint.
    Then cli.train trains FIXTURE_BATCH-example steps on the Criteo sample
    through the native parser and cli.predict scores its 96 rows."""
    from recmodels_tpu_torch.cli import export as export_cli
    from recmodels_tpu_torch.cli import predict as predict_cli
    from recmodels_tpu_torch.cli import train as train_cli
    from recmodels_tpu_torch.data import SyntheticSource
    from recmodels_tpu_torch.train.loop import Trainer
    from recmodels_tpu_torch.utils.config import TrainConfig

    print("== export and predict (j)")
    art, preds = os.path.join(work, "artifact"), os.path.join(work, "preds.txt")
    run_cli(export_cli.main, ["--ckpt-dir", loop_ckpt, "--out", art])
    out = run_cli(predict_cli.main, ["--model-dir", art, "--data", "synthetic", "--max-batches", "2", "--out", preds])
    probs = np.loadtxt(preds)
    check(probs.shape == (2 * BATCH,) and bool(np.all(np.isfinite(probs))), f"{2 * BATCH} probabilities")
    cfg = TrainConfig.from_json(open(os.path.join(loop_ckpt, "config.json")).read())
    trainer = Trainer(cfg.apply_overrides([f"ckpt_dir={loop_ckpt!r}"]))
    state, _ = trainer.ckpt.restore(trainer.engine.init(seed=cfg.seed, device=trainer.device))
    check(int(state.step) == LOOP_STEPS, f"the artifact's checkpoint is step {LOOP_STEPS}")
    src = iter(SyntheticSource(trainer.schema, batch_size=BATCH, seed=cfg.seed))
    with torch.no_grad():
        z = torch.cat([trainer.engine.logits(state, *(torch.as_tensor(a, device="cuda") for a in (b.dense, b.ids)))
                       for b in (next(src) for _ in range(2))]).double().cpu().numpy()
    err = float(np.abs(probs - 1.0 / (1.0 + np.exp(-z))).max())
    tol = 0.25 * LOGIT_REL_TOL * float(np.abs(z).max()) + 5e-7
    print(f"cli.predict against sigmoid(Engine.logits) of checkpoint {LOOP_STEPS}: max |p err| {err:.6g}, tol "
          f"{tol:.6g} (max |logit| {np.abs(z).max():.6g})")
    check(err <= tol, "the artifact's probabilities match the restored state's")
    del trainer, state

    fx, fx_preds = os.path.join(work, "fixture"), os.path.join(work, "fixture-preds.txt")
    fixture = os.path.join(ROOT, FIXTURE)
    run_cli(train_cli.main, flagship_args(FIXTURE_BATCH) + ["--data", fixture, "--steps", "4", "--ckpt-dir", fx,
                                                            "--set", "eval_every=0", "--set", "log_every=2"])
    out = run_cli(predict_cli.main, ["--ckpt-dir", fx, "--data", fixture, "--batch-size", str(FIXTURE_BATCH),
                                      "--out", fx_preds])
    fp = np.loadtxt(fx_preds)
    check(fp.shape == (96,) and bool(np.all((fp > 0) & (fp < 1))), "96 probabilities of the Criteo sample")
    check("eval n=96 auc=" in out, "the Criteo sample's 96 rows scored")
    print(f"Criteo sample (native parser): 4 steps of {FIXTURE_BATCH}, 96 rows scored on {card}")


# ------------------------------------- slice 8: in-graph data generation
def synth_bound(b: int, n_dense: int, n_slots: int, signal_dim: int) -> tuple[float, str, dict]:
    """The least time of one generated batch on the card: its outputs
    written and its task read once (dense [b, n_dense] f32, ids [b, n_slots]
    int32, labels [b] f32; dense_w, slot_proj, vocab, the step) over the
    memory rate, against the kernel's integer operations (a draw: threefry
    and the float conversion, INT_OPS_PER_DRAW; an id's bucket weight,
    INT_OPS_PER_ID; each block's key derivation) over the INT32 rate."""
    nbytes = 4 * (b * (n_dense + n_slots + 1) + n_dense + n_slots * (signal_dim + 1) + 1)
    blocks = -(-b // SYNTH_ROWS)
    ops = (b * ((2 * n_dense + n_slots + 1) * INT_OPS_PER_DRAW + n_slots * INT_OPS_PER_ID)
           + blocks * SYNTH_KEY_DRAWS * (INT_OPS_PER_DRAW - 3))
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_INT32_OP_PER_S * 1e3
    bound = (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
    return bound[0], bound[1], {"bytes": nbytes, "int_ops": ops, "bytes_ms": t_bytes, "int_ops_ms": t_ops}


def generation_phase(work: str, schema, kernels, card: str, host_sustained: float,
                     host_c_ms: float) -> tuple[dict, dict[str, int]]:
    """(k) In-graph data generation on the flagship at full width:
    1. the batch kernel against its plain version at B = BATCH, steps 0, 1
       and 2^31 - 1 (the raw draws and ids equal, dense within one ulp, a
       label apart only where |u - p| < 1e-6), timed cold and warm beside
       its plain version and its bound;
    2. GEN_STEPS steps of ``jit_train_scan_gen`` against GEN_STEPS eager
       ``train_scan_gen`` steps from one state: the losses and every state
       tensor bit for bit; the captured generated step's ms beside (c') of
       the same engine;
    3. ``cli.train --data device_synth``: SUSTAIN_STEPS steps in
       superbatches of LOOP_SCAN with no checkpoint, eval or trace (every
       kernel of the step and the batch kernel must launch inside it; their
       counts set to 0 just before), its sustained examples/s beside (c')
       and the host-fed loop's (phase g), then a traced run's busy share of
       superbatches 2-4;
    4. resume: RESUME_STEPS generated steps straight against half and a
       resume (checkpoints every 10), bit for bit;
    5. eval on the generated held-out stream: ``jit_eval_gen`` over
       GEN_EVAL_BATCHES batches against eager ``eval_step``, bit for bit.
    Returns the kernel's row and the launches of the eager generated
    steps (the path's launches per step)."""
    from recmodels_tpu_torch.cli import train as train_cli
    from recmodels_tpu_torch.data import SyntheticSource
    from recmodels_tpu_torch.data import device_synth as ds
    from recmodels_tpu_torch.models import build_model
    from recmodels_tpu_torch.train.checkpoint import CheckpointManager
    from recmodels_tpu_torch.train.engine import Engine
    from recmodels_tpu_torch.train.loop import VAL_SEED_OFFSET
    from recmodels_tpu_torch.train.metrics import auc_compute, auc_init
    from recmodels_tpu_torch.utils.config import TrainConfig

    print(f"== in-graph data generation (k): the batch kernel, the generated step and loop at {BATCH}")
    dev = torch.device("cuda")
    fn = ds.make_device_batch_fn(schema, BATCH, seed=SEED)
    w, proj, vocab = fn.task(dev)
    worst_ulps, max_err, flips = 0, 0.0, 0
    for step in SYNTH_STEPS:
        st = torch.tensor(step, dtype=torch.int32, device=dev)
        d, i, l, bits = fn(st, with_bits=True)
        pd, pi, pl, pbits = ds.synth_batch_reference(st, SEED, w, proj, vocab, BATCH, with_bits=True)
        torch.cuda.synchronize()
        check(torch.equal(bits.long() & ds.M32, pbits), f"step {step}: the raw draws bit for bit")
        check(torch.equal(i, pi), f"step {step}: the ids bit for bit")
        ulps = (d.view(torch.int32) - pd.view(torch.int32)).abs().max().item()
        check(ulps <= 1, f"step {step}: dense within one ulp ({ulps})")
        z = ds.planted_logit(pd, ds.bucket_weight(pi), w, proj)
        p = torch.sigmoid(z - z.mean())
        u = ds.bits_to_unit(pbits[:, -1])
        differ = l != pl
        near = (u - p).abs() < SYNTH_LABEL_MARGIN
        check(bool(near[differ].all()), f"step {step}: labels apart only within {SYNTH_LABEL_MARGIN} of p")
        print(f"batch kernel vs plain, step {step}: draws and ids equal, dense {ulps} ulp apart at most "
              f"({(d != pd).sum().item()} of {d.numel()} values differ), labels {differ.sum().item()} apart "
              f"({near.sum().item()} within {SYNTH_LABEL_MARGIN} of p), label mean {l.mean().item():.4f}")
        worst_ulps, max_err = max(worst_ulps, ulps), max(max_err, (d - pd).abs().max().item())
        flips += differ.sum().item()
    st = torch.tensor(SYNTH_STEPS[1], dtype=torch.int32, device=dev)
    times = short_times(lambda: fn(st), lambda: ds.synth_batch_reference(st, SEED, w, proj, vocab, BATCH))
    split = launch_split(lambda: fn(st))
    bound, bound_by, counted = synth_bound(BATCH, schema.n_dense, schema.n_slots, proj.shape[1])
    print(f"batch kernel at {BATCH}: cold {times['ms']:.4f} ms, warm {times['warm_ms']} ms (by launch "
          f"{ {k: round(v, 4) for k, v in split.items()} }), events {times['event_ms']:.4f} ms; plain cold "
          f"{times['plain_ms']:.4f} ms, warm {times['plain_warm_ms']} ms; bound {bound:.4f} ms by {bound_by} "
          f"({counted['int_ops']} integer operations, {counted['int_ops_ms']:.4f} ms; {counted['bytes']} bytes, "
          f"{counted['bytes_ms']:.4f} ms) on {card}")

    # 2. the captured generated step against eager generated steps
    cfg = TrainConfig(model="xdeepfm", bf16=True, vocab_size=VOCAB, embed_dim=DIM, cin_sizes=CIN, hidden=HIDDEN)
    engine = Engine(build_model("xdeepfm", schema, **cfg.model_kwargs()))
    eager = engine.init(seed=SEED, device=dev)
    captured = to_device(eager, dev)
    for k in kernels + (ds.synth_batch,):
        k.launches = 0
    eager, me = engine.train_scan_gen(eager, 0, k=GEN_STEPS, batch_fn=fn)
    torch.cuda.synchronize()
    path = {k.__name__: k.launches for k in kernels + (ds.synth_batch,)}
    scan = engine.jit_train_scan_gen(fn)
    captured, mc = scan(captured, GEN_STEPS)
    torch.cuda.synchronize()
    check(torch.equal(me["losses"], mc["losses"]), "the captured generated steps' losses bit for bit eager")
    differ = [n for (n, x), (_, y) in zip(named_tensors(eager), named_tensors(captured)) if not torch.equal(x, y)]
    check(not differ, f"the captured generated state bit for bit eager (differ: {differ[:5]})")
    check(scan.steps.graphs == 1 and int(captured.step) == GEN_STEPS, "one graph, the step advanced")
    check(bool(torch.isfinite(mc["losses"]).all()), "finite losses")
    print(f"jit_train_scan_gen, {GEN_STEPS} steps: losses and every state tensor bit for bit the eager "
          f"train_scan_gen's (losses {me['losses'][0].item():.6f} .. {me['losses'][-1].item():.6f}); launches "
          f"a step, eager: {path}")
    gen_ms = time_ms(lambda: scan(captured, GEN_STEPS), iters=3, warmup=1) / GEN_STEPS
    b = next(iter(SyntheticSource(schema, batch_size=BATCH, seed=71)))
    batch = tuple(torch.as_tensor(a, device=dev) for a in (b.dense, b.ids, b.labels))
    ts = engine.jit_train_step()
    c_ms = time_ms(lambda: ts(eager, *batch), iters=10)
    print(f"captured generated step (jit_train_scan_gen, CUDA events, 3 x {GEN_STEPS} replays): {gen_ms:.4f} ms "
          f"per step, {BATCH / gen_ms * 1e3:.1f} examples/s; (c') of the same engine (jit_train_step, a batch "
          f"copied in, 10 calls): {c_ms:.4f} ms, {BATCH / c_ms * 1e3:.1f} examples/s; the difference "
          f"{gen_ms - c_ms:+.4f} ms on {card}")
    del eager, captured, scan, ts

    # 3. the generated loop through cli.train
    common = flagship_args() + ["--data", "device_synth", "--set", f"scan_steps={LOOP_SCAN}",
                                "--set", "log_every=10"]
    for k in kernels + (ds.synth_batch,):
        k.launches = 0
    sustain = run_cli(train_cli.main, common + ["--steps", str(SUSTAIN_STEPS), "--set", "eval_every=0"])
    launches = {k.__name__: k.launches for k in kernels + (ds.synth_batch,)}
    print(f"launches inside the generated loop (eager warm-up and capture; replays are not counted): {launches}")
    for name, count in launches.items():
        check(count > 0, f"{name} launched inside the generated loop")
    train = logged(sustain, "train")
    rates = [sc["examples_per_sec"] for step, sc in train if step > SUSTAIN_FROM]
    check(len(rates) == (SUSTAIN_STEPS - SUSTAIN_FROM) // 10, "a train line every 10 steps of the generated run")
    check(train[-1][1]["loss"] < train[0][1]["loss"],
          f"the generated run's last logged loss ({train[-1][1]['loss']}) is below the first")
    sustained = float(np.median(rates))
    print(f"generated loop, sustained ({SUSTAIN_STEPS} steps, no checkpoint, eval or trace; the intervals after step "
          f"{SUSTAIN_FROM}): median {sustained:.1f} examples/s (min {min(rates):.1f}, max {max(rates):.1f}); "
          f"{sustained / (BATCH / c_ms * 1e3):.1%} of (c') {c_ms:.4f} ms, "
          f"{sustained / (BATCH / gen_ms * 1e3):.1%} of the captured generated step; the host-fed loop "
          f"(phase g) {host_sustained:.1f} examples/s against its (c') {host_c_ms:.4f} ms, on {card}")
    trace_dir = os.path.join(work, "gen-trace")
    run_cli(train_cli.main, common + ["--steps", str(GEN_TRACE_STEPS), "--set", "eval_every=0",
                                      "--profile-dir", trace_dir])
    busy, window = trace_busy(os.path.join(trace_dir, "trace.json"))
    print(f"generated loop, superbatches 2-4 (torch.profiler): the card busy {busy:.3f} ms of a {window:.3f} ms "
          f"window ({busy / window:.1%}) on {card}")

    # 4. resume
    rcommon = common + ["--set", "ckpt_every=10", "--set", "eval_every=0"]
    a, b = os.path.join(work, "gen-resume-a"), os.path.join(work, "gen-resume-b")
    run_cli(train_cli.main, rcommon + ["--steps", str(RESUME_STEPS), "--ckpt-dir", a])
    run_cli(train_cli.main, rcommon + ["--steps", str(RESUME_STEPS // 2), "--ckpt-dir", b])
    out = run_cli(train_cli.main, rcommon + ["--steps", str(RESUME_STEPS), "--ckpt-dir", b])
    check(f"resumed from checkpoint at step {RESUME_STEPS // 2}" in out, "the generated run resumed at the half")
    ta = saved_tensors(os.path.join(a, str(RESUME_STEPS), "state.pt"))
    tb = saved_tensors(os.path.join(b, str(RESUME_STEPS), "state.pt"))
    check([n for n, _ in ta] == [n for n, _ in tb], "the two final generated states hold the same tensors")
    differ = [n for (n, x), (_, y) in zip(ta, tb) if not torch.equal(x, y)]
    check(not differ, f"the resumed generated run bit for bit the straight one (differ: {differ[:5]})")
    print(f"generated resume: all {len(ta)} tensors of the two step-{RESUME_STEPS} states equal bit for bit")

    # 5. eval on the generated held-out stream, captured against eager
    state, _ = CheckpointManager(a).restore(engine.init(seed=SEED, device=dev))
    check(int(state.step) == RESUME_STEPS, f"the restored generated state is step {RESUME_STEPS}")
    val_fn = ds.make_device_batch_fn(schema, BATCH, seed=SEED + VAL_SEED_OFFSET)
    want, got = auc_init(device=dev), auc_init(device=dev)
    index = torch.zeros((), dtype=torch.int32, device=dev)
    eval_gen = engine.jit_eval_gen(val_fn)
    for k in range(GEN_EVAL_BATCHES):
        engine.eval_step(state, want, *val_fn(torch.tensor(k, dtype=torch.int32, device=dev)))
        eval_gen(state, got, index)
    torch.cuda.synchronize()
    check(eval_gen.captured.graphs == 1 and int(index) == GEN_EVAL_BATCHES, "one eval graph, the index advanced")
    check(all(torch.equal(x, y) for x, y in zip(want, got)), "the captured generated eval bit for bit eager")
    out = auc_compute(got)
    index.zero_()
    eval_ms = time_ms(lambda: eval_gen(state, got, index), iters=GEN_EVAL_BATCHES, warmup=0)
    print(f"generated eval, {GEN_EVAL_BATCHES} held-out batches of {BATCH} at step {RESUME_STEPS}: captured bit for "
          f"bit eager; AUC {float(out['auc']):.6f}, logloss {float(out['logloss']):.6f}; captured {eval_ms:.4f} ms "
          f"a batch (generation included) on {card}")
    row = {"route": "cuda", "source": "recmodels_tpu_torch/csrc/device_synth.cu",
           "replaces": "none: recmodels_tpu/data/device_synth.py:69 batch_fn (jax.random, no pl.pallas_call)",
           "max_abs_err": max_err, **times, "bound_ms": bound, "bound_by": bound_by, "library_ms": None,
           "warm_by_launch": split, "loop_launches": launches["synth_batch"], "dense_ulps": worst_ulps,
           "label_flips": flips, **counted,
           "gen_step_ms": gen_ms, "c_prime_ms": c_ms, "gen_sustained_examples_per_s": sustained,
           "host_sustained_examples_per_s": host_sustained, "gen_busy": busy / window,
           "timing": SHORT_TIMING}
    return row, path


def serving_phase(title: str, cfg, engine, kernels, terms, dense_np, ids_np, card: str,
                  gen: torch.Generator, rows_scale: float = 10.0) -> dict[str, int]:
    """Serve ``cfg``'s model, initialised from SEED and made live, from an
    exported artifact loaded with load_predictor(device="cuda"): requests of
    1, 1,000 and the whole batch. Every kernel in ``kernels`` must launch,
    the logits must be finite, agree across request sizes and match the same
    artifact served on the CPU at 1,024 examples; each term that
    ``terms(cpu_predictor, dense, ids)`` reports must move some logit by
    TERM_MIN_TOLS logit tolerances. Prints the throughput at the batch and a
    profile; returns the launches over the three requests."""
    from recmodels_tpu_torch.serve import export_model, load_predictor

    print(f"== serving ({title})")
    dev = torch.device("cuda")
    n = ids_np.shape[0]
    dense = torch.as_tensor(dense_np, device=dev)
    ids = torch.as_tensor(ids_np, device=dev)
    state = engine.init(seed=SEED, device=dev)
    liven(state, gen, rows_scale)
    with tempfile.TemporaryDirectory() as art:
        export_model(art, cfg, engine, state)
        del state
        pred = load_predictor(art, device="cuda")
        for k in kernels:
            k.launches = 0
        answers = {}
        for size in (1, 1000, n):
            answers[size] = pred.predict_logits(dense_np[:size], ids_np[:size])
            check(answers[size].shape == (size,) and bool(np.all(np.isfinite(answers[size]))),
                  f"{size} finite logits")
        launches = {k.__name__: k.launches for k in kernels}
        print(f"launches over the three requests: {launches}")
        for name, count in launches.items():
            check(count > 0, f"{name} launched on the serving path")
        for size in (1, 1000):
            err, scale = rel_err(torch.as_tensor(answers[size]), torch.as_tensor(answers[n][:size]))
            check(err <= LOGIT_REL_TOL * scale, f"request of {size} agrees with the batch of {n}")
        cpu_pred = load_predictor(art, device="cpu")
        cpu = cpu_pred.predict_logits(dense_np[:1024], ids_np[:1024])
        err, scale = rel_err(torch.as_tensor(answers[n][:1024]), torch.as_tensor(cpu))
        tol = LOGIT_REL_TOL * scale
        print(f"GPU vs CPU logits (1,024 requests): max err {err:.6g}, max |ref| {scale:.6g}, "
              f"tol {tol:.6g}")
        check(err <= tol, "GPU logits match the CPU plain path")
        for name, size in terms(cpu_pred, dense_np[:1024], ids_np[:1024]).items():
            print(f"term {name}: max |contribution| {size:.6g} = {size / tol:.1f} x the logit tol")
            check(size >= TERM_MIN_TOLS * tol, f"{name} moves the logits by >= {TERM_MIN_TOLS} tols")
        del cpu_pred

        # the captured scorer: one graph a bucket, each request's logits
        # against eager Engine.logits on the unpadded request
        check(sorted(pred._buckets) == sorted({pred._bucket(size) for size in answers})
              and all(bk.graph is not None for bk in pred._buckets.values()),
              f"one graph a bucket {sorted(pred._buckets)}")
        for size, got in answers.items():
            with torch.inference_mode():
                eager = pred.engine.logits(pred.state, dense[:size], ids[:size]).cpu()
            err, scale = rel_err(torch.as_tensor(got), eager)
            print(f"captured Predictor at {size} (bucket {pred._bucket(size)}) vs eager Engine.logits: max err "
                  f"{err:.6g}, max |ref| {scale:.6g}, tol {LOGIT_REL_TOL * scale:.6g}")
            check(err <= LOGIT_REL_TOL * scale, f"captured Predictor at {size} matches eager Engine.logits")
        for size, bucket in sorted(pred._buckets.items()):
            with torch.inference_mode():
                eager_ms = time_ms(lambda: pred.engine.logits(pred.state, bucket.dense, bucket.ids), iters=10)
            replay_ms = time_ms(bucket.graph.replay, iters=10)
            print(f"serving bucket {size} ({title}): eager Engine.logits {eager_ms:.4f} ms, captured replay "
                  f"{replay_ms:.4f} ms per request (CUDA events, 10 back-to-back), {size / replay_ms * 1e3:.0f} "
                  f"examples/s captured, on {card}")

        with torch.inference_mode():
            logits_ms = time_ms(lambda: pred.engine.logits(pred.state, dense, ids), iters=10)
        t_host = []
        for _ in range(5):
            t0 = time.perf_counter()
            pred.predict_logits(dense_np, ids_np)
            t_host.append(time.perf_counter() - t0)
        predict_ms = float(np.median(t_host)) * 1e3
        print(f"Engine.logits at {n} ({title}): {logits_ms:.4f} ms device time, "
              f"{n / logits_ms * 1e3:.0f} examples/s on {card}")
        print(f"predict_logits at {n} (numpy in and out, padded to its bucket, one replay): {predict_ms:.4f} ms "
              f"median of 5, {n / predict_ms * 1e3:.0f} examples/s on {card}")
        with torch.inference_mode():
            profile(lambda: pred.engine.logits(pred.state, dense, ids))
    return launches


def training_phase(title: str, engine, schema, batch_size: int, kernels, seed: int, card: str,
                   gen: torch.Generator, rows_scale: float = 10.0, scan: bool = False,
                   evaluate: bool = False) -> dict[str, int]:
    """Train ``engine``'s model (one table, sparse Adagrad) on the card for
    TRAIN_STEPS steps of the synthetic stream (``seed``) at ``batch_size``;
    every kernel in ``kernels`` must launch on every step and the loss must
    fall; one step from live weights at TRAIN_CHECK_BATCH must match the CPU
    plain path's step; then the captured step on the same batches
    (``captured_phase``, with ``jit_train_scan`` where ``scan``). Where
    ``evaluate``, ``eval_phase`` scores the state of the TRAIN_STEPS steps
    before the one-step check changes it. Returns
    each kernel's launches over the TRAIN_STEPS eager steps (the counts are
    set to 0 just before them and read just after)."""
    from recmodels_tpu_torch.data import SyntheticSource

    print(f"== training ({title})")
    dev = torch.device("cuda")
    src = iter(SyntheticSource(schema, batch_size=batch_size, seed=seed))
    batches = []
    for _ in range(TRAIN_STEPS):
        b = next(src)
        batches.append(tuple(torch.as_tensor(a, device=dev) for a in (b.dense, b.ids, b.labels)))
    state = engine.init(seed=SEED, device=dev)
    torch.cuda.synchronize()
    for k in kernels:
        k.launches = 0
    losses = []
    t0 = time.perf_counter()
    for dense, ids, labels in batches:
        state, metrics = engine.train_step(state, dense, ids, labels)
        losses.append(metrics["loss"])
    losses = torch.stack(losses).cpu()
    wall = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in kernels}
    print(f"launches over {TRAIN_STEPS} steps: {launches}")
    for name, count in launches.items():
        check(count >= TRAIN_STEPS, f"{name} launched on every training step")
    print("losses: " + " ".join(f"{v:.5f}" for v in losses.tolist()))
    first, last = losses[:5].mean().item(), losses[-5:].mean().item()
    print(f"loss: mean of the first 5 steps {first:.6f}, of the last 5 {last:.6f} "
          f"({TRAIN_STEPS} steps in {wall:.3f} s, first steps included)")
    check(bool(torch.isfinite(losses).all()), "finite losses")
    check(last < first, "the loss falls over the steps")
    if evaluate:
        eval_phase(title, engine, schema, state, card)

    state = one_step_check(engine, state, batches[0], gen, rows_scale)

    dense, ids, labels = batches[-1]
    step_ms = time_ms(lambda: engine.train_step(state, dense, ids, labels), iters=10)
    t_host = []
    for _ in range(5):
        t0 = time.perf_counter()
        engine.train_step(state, dense, ids, labels)
        torch.cuda.synchronize()
        t_host.append(time.perf_counter() - t0)
    host_ms = float(np.median(t_host)) * 1e3
    name = engine.model.name
    print(f"Engine.train_step ({name}) at {batch_size}: {step_ms:.4f} ms per step (CUDA events, 10 "
          f"back-to-back steps), {batch_size / step_ms * 1e3:.0f} examples/s on {card}")
    print(f"Engine.train_step ({name}) at {batch_size} one at a time (host clock to synchronize): "
          f"{host_ms:.4f} ms median of 5, {batch_size / host_ms * 1e3:.0f} examples/s on {card}")
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    busy, _, per_step = profile(lambda: engine.train_step(state, dense, ids, labels), top=20)
    print(f"Engine.train_step ({name}) at {batch_size}: {busy:.4f} ms of kernel time per step "
          f"(profiler), {batch_size / busy * 1e3:.0f} examples/s if the host kept the card busy, "
          f"{per_step} kernel launches a step, on {card}")
    del state
    captured_phase(title, engine, batches, card, step_ms, busy, scan=scan)
    return launches


def eval_phase(title: str, engine, schema, state, card: str) -> None:
    """Evaluate the trained ``state`` on EVAL_BATCHES batches of BATCH from
    the stream EVAL_SEED (the training task) and a tail batch whose first
    EVAL_TAIL rows count (``weight`` 0/1), each through ``Engine.eval_step``
    and through ``Engine.jit_eval_step`` into two AUC states: they must
    agree bit for bit. The card's logits copied to the CPU must give, by the
    CPU's ``auc_update``, the same histograms and count and the loss sum to
    LOSS_SUM_RTOL; the AUC must lie within AUC_TOL of the exact rank AUC of
    those logits (scipy's midranks). Prints the eager and the captured eval
    step's events per batch."""
    from scipy.stats import rankdata

    from recmodels_tpu_torch.data import SyntheticSource
    from recmodels_tpu_torch.train.metrics import auc_compute, auc_init, auc_update

    print(f"== eval ({title}): {EVAL_BATCHES} batches of {BATCH} (stream {EVAL_SEED}) and a tail batch of "
          f"{EVAL_TAIL} kept rows")
    dev = torch.device("cuda")
    src = iter(SyntheticSource(schema, batch_size=BATCH, seed=EVAL_SEED))
    batches = [tuple(torch.as_tensor(a, device=dev) for a in (b.dense, b.ids, b.labels))
               for b in (next(src) for _ in range(EVAL_BATCHES + 1))]
    weights = [None] * EVAL_BATCHES + [(torch.arange(BATCH, device=dev) < EVAL_TAIL).float()]
    eager, captured, cpu = auc_init(device=dev), auc_init(device=dev), auc_init(device="cpu")
    es = engine.jit_eval_step()
    kept_z, kept_y = [], []
    for (dense, ids, labels), w in zip(batches, weights):
        engine.eval_step(state, eager, dense, ids, labels, w)
        check(es(state, captured, dense, ids, labels, w) is captured, "jit_eval_step returns its AUC state")
        with torch.no_grad():
            z = engine.logits(state, dense, ids).cpu()
        y = labels.cpu()
        auc_update(cpu, z, y, None if w is None else w.cpu())
        keep = torch.ones_like(y, dtype=torch.bool) if w is None else w.cpu() > 0
        kept_z.append(z[keep])
        kept_y.append(y[keep])
    torch.cuda.synchronize()
    # the weighted tail is a shape of its own, and its one call is that
    # shape's eager warm-up: one graph, the unweighted batches'
    check(es.graphs == 1, f"one graph for the unweighted batches ({es.graphs})")
    same = all(torch.equal(a, b) for a, b in zip(eager, captured))
    print(f"eval: jit_eval_step's AUC state {'equals' if same else 'differs from'} eval_step's, bit for bit")
    check(same, "jit_eval_step's AUC state equals eval_step's bit for bit")
    n = EVAL_BATCHES * BATCH + EVAL_TAIL
    for name in ("pos_hist", "neg_hist", "count"):
        check(torch.equal(getattr(eager, name).cpu(), getattr(cpu, name)),
              f"the card's {name} equals the CPU auc_update's on the card's logits")
    check(int(eager.count) == n and int(eager.pos_hist.sum() + eager.neg_hist.sum()) == n,
          f"{n} examples counted")
    loss_err = abs(float(eager.loss_sum) - float(cpu.loss_sum)) / abs(float(cpu.loss_sum))
    check(loss_err <= LOSS_SUM_RTOL, f"eval loss sum within {LOSS_SUM_RTOL} of the CPU's ({loss_err:.3g})")
    out = auc_compute(eager)
    z, y = torch.cat(kept_z).double().numpy(), torch.cat(kept_y).numpy() > 0.5
    n_pos, n_neg = int(y.sum()), int((~y).sum())
    exact = (rankdata(z)[y].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg)
    err = abs(float(out["auc"]) - exact)
    print(f"eval: AUC {float(out['auc']):.6f} (exact rank AUC {exact:.6f}, err {err:.3g}, tol {AUC_TOL}), logloss "
          f"{float(out['logloss']):.6f}, accuracy {float(out['accuracy']):.6f}, {out['count']:.0f} examples; "
          f"histograms and count equal to the CPU's, loss sum {loss_err:.3g} apart")
    check(err <= AUC_TOL, f"histogram AUC within {AUC_TOL} of the exact AUC")
    dense, ids, labels = batches[0]
    eager_t, captured_t = auc_init(device=dev), auc_init(device=dev)
    eager_ms = time_ms(lambda: engine.eval_step(state, eager_t, dense, ids, labels), iters=10)
    captured_ms = time_ms(lambda: es(state, captured_t, dense, ids, labels), iters=10)
    print(f"eval step at {BATCH} ({title}): eager {eager_ms:.4f} ms, captured {captured_ms:.4f} ms per batch "
          f"(CUDA events, 10 back-to-back calls; captured: batch copied in, one replay), "
          f"{BATCH / captured_ms * 1e3:.0f} examples/s captured, on {card}")


def named_tensors(tree, prefix: str = ""):
    """(path, tensor) for every tensor of a state, in a fixed order."""
    if isinstance(tree, torch.Tensor):
        yield prefix, tree
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for k, v in zip(tree._fields, tree):
            yield from named_tensors(v, f"{prefix}{k}/")
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from named_tensors(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from named_tensors(v, f"{prefix}{i}/")


def captured_phase(title: str, engine, batches, card: str, eager_ms: float, kernel_ms: float,
                   scan: bool = False) -> None:
    """TRAIN_STEPS steps through ``Engine.jit_train_step`` (an eager warm-up,
    the capture and its replay, then replays) against as many eager
    ``train_step``s from one start state (``engine.init(seed=SEED)``, cloned)
    on the same batches, in lockstep. Prints whether the bits agree and, if
    not, the first step and tensor that differ; every step's loss must agree
    within LOGIT_REL_TOL of max |logit|, and every tensor of the final state
    within STEP_REL_TOL of its largest change over the run (the one-step
    check's tolerances); the captured losses must be finite and fall. Where
    ``scan``, one ``jit_train_scan`` of TRAIN_STEPS steps from the same start
    must give the stepwise captured losses bit for bit. Then the captured
    step's events per step over 10 back-to-back calls beside the eager
    events and kernel time, and a profile of replays. The wrappers' launch
    counts see the warm-up and the capture, not the replays: the kernels
    show they ran by the state changing as the eager run's did."""
    print(f"== captured training ({title})")
    dev = torch.device("cuda")
    eager = engine.init(seed=SEED, device=dev)
    captured, start = to_device(eager, dev), to_device(eager, dev)
    ts = engine.jit_train_step()
    first_diff = None
    losses_e, losses_c = [], []
    t0 = time.perf_counter()
    for k, (dense, ids, labels) in enumerate(batches):
        eager, me = engine.train_step(eager, dense, ids, labels)
        captured, mc = ts(captured, dense, ids, labels)
        losses_e.append(me["loss"])
        losses_c.append(mc["loss"])
        if first_diff is None:
            if not torch.equal(me["loss"], mc["loss"]):
                first_diff = (k, "loss")
            for (name, a), (_, b) in zip(named_tensors(eager), named_tensors(captured)):
                if first_diff is None and not torch.equal(a, b):
                    first_diff = (k, name)
    wall = time.perf_counter() - t0
    check(ts.graphs == 1, f"one graph captured ({ts.graphs})")
    if first_diff is None:
        print(f"captured vs eager over {len(batches)} steps: the bits agree (every loss and every state "
              f"tensor after every step); {wall:.3f} s for both runs, capture included")
    else:
        print(f"captured vs eager over {len(batches)} steps: the bits differ, first at step {first_diff[0]} "
              f"in {first_diff[1]}")
    le, lc = torch.stack(losses_e).cpu(), torch.stack(losses_c).cpu()
    print("captured losses: " + " ".join(f"{v:.5f}" for v in lc.tolist()))
    check(bool(torch.isfinite(lc).all()), "finite captured losses")
    check(lc[-5:].mean() < lc[:5].mean(), "the captured loss falls over the steps")
    dense, ids, _ = batches[0]
    with torch.no_grad():
        max_logit = engine.logits(eager, dense[:TRAIN_CHECK_BATCH], ids[:TRAIN_CHECK_BATCH]).abs().max().item()
    loss_err = (lc - le).abs().max().item()
    check(loss_err <= LOGIT_REL_TOL * max_logit,
          f"captured losses within {LOGIT_REL_TOL} of max |logit| of the eager ones ({loss_err:.6g})")
    worst = (0.0, "")
    for (name, e), (_, c), (_, s0) in zip(named_tensors(eager), named_tensors(captured), named_tensors(start)):
        if not e.is_floating_point():
            check(torch.equal(e, c), f"captured {name} equals the eager run's ({int(c)}, {int(e)})")
            continue
        err = (c - e).abs().max().item()
        change = (e - s0).abs().max().item()
        check(err <= STEP_REL_TOL * change, f"captured {name} within {STEP_REL_TOL} of its largest change "
              f"(err {err:.6g}, change {change:.6g})")
        if change > 0 and err / change >= worst[0]:
            worst = (err / change, name)
    print(f"captured vs eager: largest loss error {loss_err:.6g} (tol {LOGIT_REL_TOL * max_logit:.6g}); largest "
          f"state error {worst[0]:.6g} of its tensor's change ({worst[1] or 'none'}), tol {STEP_REL_TOL}")
    del eager, start
    if scan:
        scanned = engine.init(seed=SEED, device=dev)
        stacked = [torch.stack([b[i] for b in batches]) for i in range(3)]
        scanned, m = engine.jit_train_scan()(scanned, *stacked)
        check(torch.equal(m["losses"].cpu(), lc), f"jit_train_scan of {len(batches)} steps gives the stepwise "
              "captured losses bit for bit")
        print(f"jit_train_scan, K = {len(batches)}: losses bit for bit the stepwise captured run's")
        del scanned, stacked, m
    dense, ids, labels = batches[-1]
    n = dense.shape[0]
    step_ms = time_ms(lambda: ts(captured, dense, ids, labels), iters=10)
    busy, share, per_step = profile(lambda: ts(captured, dense, ids, labels), top=12)
    print(f"captured step ({title}) at {n}: {step_ms:.4f} ms per step (CUDA events, 10 back-to-back calls of "
          f"jit_train_step: batch copied in, one replay, loss copied out), {n / step_ms * 1e3:.0f} examples/s; "
          f"eager {eager_ms:.4f} ms; kernels {kernel_ms:.4f} ms (eager profile), {busy:.4f} ms in the replay's "
          f"profile ({share:.1%} busy, {per_step} launches); on {card}")
    del captured


def one_step_check(engine, state, batch, gen: torch.Generator, rows_scale: float = 10.0, dim: int = DIM):
    """One step from a live state (``liven``) at TRAIN_CHECK_BATCH examples
    of ``batch`` on the card and on the CPU plain path, for a model with one
    table (``emb``, or LR's 1-D ``wide``) and sparse Adagrad: the loss within LOGIT_REL_TOL of max |logit|,
    Adam's moments and the touched rows of the table and acc within
    STEP_REL_TOL of their largest change, untouched rows bit for bit.
    Returns the card's state after the step."""
    liven(state, gen, rows_scale, dim)
    dense, ids, labels = (t[:TRAIN_CHECK_BATCH] for t in batch)
    cpu_state = to_device(state, "cpu")
    before = to_device(state, "cpu")
    cpu_in = [t.cpu() for t in (dense, ids, labels)]
    with torch.no_grad():
        max_logit = engine.logits(cpu_state, cpu_in[0], cpu_in[1]).abs().max().item()
    state, gm = engine.train_step(state, dense, ids, labels)
    cpu_state, cm = engine.train_step(cpu_state, *cpu_in)
    loss_err = abs(gm["loss"].item() - cm["loss"].item())
    loss_tol = LOGIT_REL_TOL * max_logit  # BCE is 1-Lipschitz in each logit
    print(f"GPU vs CPU step at {TRAIN_CHECK_BATCH}: loss {gm['loss'].item():.6f} vs "
          f"{cm['loss'].item():.6f} (err {loss_err:.6g}, tol {loss_tol:.6g})")
    check(loss_err <= loss_tol, "GPU loss matches the CPU step")
    errs = {}
    for name, i in (("mu", "mu"), ("nu", "nu")):
        for j, (g, c, b) in enumerate(zip(state.dense_opt[i], cpu_state.dense_opt[i], before.dense_opt[i])):
            errs[f"{name}/{j}"] = check_step(f"Adam {name} leaf {j}", g, c, b)
    # the dense grads are held through the moments above. Adam's step
    # m/(sqrt(v) + eps) is near lr * sign(g) where this step's grads outgrow
    # the history (as after liven), so grads that agree to 2^-8 can give
    # params a sizeable share of a step apart: the params are not compared.
    ((cname, groups),) = state.emb_params.items()
    (gname,) = groups

    def rows2d(t):  # dim-1 tables are 1-D
        return t.reshape(t.shape[0], -1)

    table_b = rows2d(before.emb_params[cname][gname])
    acc_b = rows2d(before.emb_opt[cname][gname]["acc"])
    gpu_t = rows2d(state.emb_params[cname][gname].cpu())
    gpu_a = rows2d(state.emb_opt[cname][gname]["acc"].cpu())
    cpu_t, cpu_a = rows2d(cpu_state.emb_params[cname][gname]), rows2d(cpu_state.emb_opt[cname][gname]["acc"])
    touched = torch.zeros(table_b.shape[0], dtype=torch.bool)
    touched[engine.collections[cname].group_row_ids(cpu_in[1])[gname].reshape(-1).long()] = True
    # the fused wide column's grads outgrow the embedding columns': each part
    # is held to its own largest change
    parts = ((("embedding columns", slice(0, -1)), ("wide column", slice(-1, None)))
             if table_b.shape[1] == dim + 1 else (("all columns", slice(None)),))
    for part, cols in parts:
        for name, gpu, cpu, b in (("table", gpu_t, cpu_t, table_b), ("acc", gpu_a, cpu_a, acc_b)):
            errs[f"{name}/{part}"] = check_step(f"touched {name} rows, {part}", gpu[touched, cols],
                                                cpu[touched, cols], b[touched, cols])
    check(torch.equal(gpu_t[~touched], table_b[~touched]) and torch.equal(cpu_t[~touched], table_b[~touched])
          and torch.equal(gpu_a[~touched], acc_b[~touched]), "untouched rows bit-identical")
    print(f"GPU vs CPU step: {int(touched.sum())} touched rows; largest errors: table "
          f"{max(v for k, v in errs.items() if k.startswith('table')):.6g}, acc "
          f"{max(v for k, v in errs.items() if k.startswith('acc')):.6g}, Adam mu "
          f"{max(v for k, v in errs.items() if k.startswith('mu')):.6g}, Adam nu "
          f"{max(v for k, v in errs.items() if k.startswith('nu')):.6g}; untouched rows bit-identical")
    del cpu_state, before
    return state


def training3_phase(engine3, schema, card: str, gen: torch.Generator) -> dict[str, int]:
    """Train the slice-3 path on the card; returns each kernel's launches
    over the TRAIN_STEPS steps (the counts are set to 0 just before them and
    read just after)."""
    from recmodels_tpu_torch.data import SyntheticSource
    from recmodels_tpu_torch.embedding.gather import gather_rows
    from recmodels_tpu_torch.embedding.update import adam_scalars, sorted_adam_update
    from recmodels_tpu_torch.ops.cuda.interactions_cuda import (
        cin_layer_backward, cin_layer_forward, transpose_minor2,
    )

    print("== training, slice 3 (bf16 xDeepFM, CIN(128,128,128), unfused wide table, "
          "Adam 1e-3 + lazy Adam 1e-2)")
    dev = torch.device("cuda")
    kernels = (gather_rows, transpose_minor2, cin_layer_forward, cin_layer_backward, sorted_adam_update)
    src = iter(SyntheticSource(schema, batch_size=BATCH, seed=13))
    batches = []
    for _ in range(TRAIN_STEPS):
        b = next(src)
        batches.append(tuple(torch.as_tensor(a, device=dev) for a in (b.dense, b.ids, b.labels)))
    state = engine3.init(seed=SEED, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in kernels:
        k.launches = 0
    losses = []
    t0 = time.perf_counter()
    for dense, ids, labels in batches:
        state, metrics = engine3.train_step(state, dense, ids, labels)
        losses.append(metrics["loss"])
    losses = torch.stack(losses).cpu()
    wall = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in kernels}
    print(f"launches over {TRAIN_STEPS} steps: {launches}")
    for name, count in launches.items():
        check(count >= TRAIN_STEPS, f"{name} launched on every training step")
    print("losses: " + " ".join(f"{v:.5f}" for v in losses.tolist()))
    first, last = losses[:5].mean().item(), losses[-5:].mean().item()
    print(f"loss: mean of the first 5 steps {first:.6f}, of the last 5 {last:.6f} "
          f"({TRAIN_STEPS} steps in {wall:.3f} s, first steps included)")
    check(bool(torch.isfinite(losses).all()), "finite losses")
    check(last < first, "the loss falls over the steps")

    # one step from a live state on the card and on the CPU plain path
    liven(state, gen)
    dense, ids, labels = (t[:TRAIN_CHECK_BATCH] for t in batches[0])
    cpu_state = to_device(state, "cpu")
    before = to_device(state, "cpu")
    cpu_in = [t.cpu() for t in (dense, ids, labels)]
    with torch.no_grad():
        max_logit = engine3.logits(cpu_state, cpu_in[0], cpu_in[1]).abs().max().item()
    state, gm = engine3.train_step(state, dense, ids, labels)
    cpu_state, cm = engine3.train_step(cpu_state, *cpu_in)
    loss_err = abs(gm["loss"].item() - cm["loss"].item())
    loss_tol = LOGIT_REL_TOL * max_logit  # BCE is 1-Lipschitz in each logit
    print(f"GPU vs CPU step at {TRAIN_CHECK_BATCH}: loss {gm['loss'].item():.6f} vs "
          f"{cm['loss'].item():.6f} (err {loss_err:.6g}, tol {loss_tol:.6g})")
    check(loss_err <= loss_tol, "GPU loss matches the CPU step")
    errs = {}
    for name in ("mu", "nu"):
        for j, (g, c, b) in enumerate(zip(state.dense_opt[name], cpu_state.dense_opt[name],
                                          before.dense_opt[name])):
            errs[f"{name}/{j}"] = check_step(f"Adam {name} leaf {j}", g, c, b)
    # each table's moments carry its grads and are held to the CPU step; the
    # table moves by the Adam step of the card's own moments (lazy Adam
    # normalises the grad, so a grad within bf16 rounding of 0 moves an
    # element by most of a step either way: the table is not compared
    # element by element)
    for coll_name, coll in engine3.collections.items():
        (grp,) = coll.groups
        touched = torch.zeros(grp.alloc_rows, dtype=torch.bool)
        touched[coll.group_row_ids(cpu_in[1])[grp.name].reshape(-1).long()] = True
        gpu = [state.emb_params[coll_name][grp.name].cpu()] + [
            state.emb_opt[coll_name][grp.name][k].cpu() for k in ("m", "v")]
        cpu = [cpu_state.emb_params[coll_name][grp.name]] + [
            cpu_state.emb_opt[coll_name][grp.name][k] for k in ("m", "v")]
        old = [before.emb_params[coll_name][grp.name]] + [
            before.emb_opt[coll_name][grp.name][k] for k in ("m", "v")]
        for k, name in ((1, "m"), (2, "v")):
            errs[f"{coll_name}/{name}"] = check_step(f"{coll_name} table's {name}, touched rows",
                                                     gpu[k][touched], cpu[k][touched], old[k][touched])
        scalars = adam_scalars(torch.tensor(engine3.emb_lr, device=dev), before.step.to(dev), 0.9, 0.999)
        want = adam_step_of(old[0][touched], gpu[1][touched], gpu[2][touched], scalars)
        check(torch.equal(gpu[0][touched], want),
              f"{coll_name} table moved by the Adam step of its moments, bit for bit")
        check(all(torch.equal(a[~touched], o[~touched]) and torch.equal(c[~touched], o[~touched])
                  for a, c, o in zip(gpu, cpu, old)), f"{coll_name}: untouched rows bit-identical")
        print(f"{coll_name} table: {int(touched.sum())} touched rows; largest errors m "
              f"{errs[f'{coll_name}/m']:.6g}, v {errs[f'{coll_name}/v']:.6g}; the table's step is its "
              f"moments' Adam step; untouched rows of table, m and v bit-identical")
    print(f"GPU vs CPU step: Adam mu {max(v for k, v in errs.items() if k.startswith('mu')):.6g}, "
          f"nu {max(v for k, v in errs.items() if k.startswith('nu')):.6g}")
    del cpu_state, before

    dense, ids, labels = batches[-1]
    step_ms = time_ms(lambda: engine3.train_step(state, dense, ids, labels), iters=10)
    print(f"Engine.train_step (slice 3) at {BATCH}: {step_ms:.4f} ms per step (CUDA events, 10 "
          f"back-to-back steps), {BATCH / step_ms * 1e3:.0f} examples/s on {card}")
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    busy, share, per_step = profile(lambda: engine3.train_step(state, dense, ids, labels), top=24)
    print(f"Engine.train_step (slice 3) at {BATCH}: {busy:.4f} ms of kernel time per step (profiler), "
          f"{BATCH / busy * 1e3:.0f} examples/s if the host kept the card busy, on {card}")
    print(f"slice-3 step: events {step_ms:.4f} ms, kernels {busy:.4f} ms, device busy {share:.1%} of the "
          f"profiled window, {per_step} kernel launches a step (one sort for both tables' ids), on {card}")
    del state
    captured_phase("slice 3", engine3, batches, card, step_ms, busy)
    return launches


def repaired_shapes_phase(card: str, gen: torch.Generator) -> None:
    """Shapes the card once refused (ROADMAP queue 3), served and trained one
    step at REPAIR_BATCH examples against the CPU plain path: bf16 xDeepFM at
    dim 32 (CIN(128,128)), with CIN(256,256) and with CIN(100,100), which
    take the fused CIN kernels (CIN(100,100) zero-padded to 112), and bf16
    DCN at dim 40 (x0 of 1,053, the cross stack's wide-row path). The route
    must launch the kernels ``cin2_route_widths`` names and no others."""
    from recmodels_tpu_torch.data import SyntheticSource
    from recmodels_tpu_torch.models import build_model
    from recmodels_tpu_torch.ops.cuda.interactions_cuda import (
        cin2_backward, cin2_forward, cin_layer_forward, dcn_cross_stack_forward,
    )
    from recmodels_tpu_torch.serve import export_model, load_predictor
    from recmodels_tpu_torch.train.engine import Engine
    from recmodels_tpu_torch.utils.config import TrainConfig, build_schema

    dev = torch.device("cuda")
    fused = {cin2_forward: True, cin_layer_forward: False}
    cases = (
        ("xdeepfm", 32, dict(cin_sizes=CIN, hidden=HIDDEN), fused, {cin2_backward: True}),
        ("xdeepfm", DIM, dict(cin_sizes=(256, 256), hidden=HIDDEN), fused, {cin2_backward: True}),
        ("xdeepfm", DIM, dict(cin_sizes=(100, 100), hidden=HIDDEN), fused, {cin2_backward: True}),
        ("dcn", 40, dict(hidden=DCN_HIDDEN, n_cross=N_CROSS), {dcn_cross_stack_forward: True}, {}),
    )
    for model, dim, kw, serve_route, train_route in cases:
        title = f"bf16 {model}, dim {dim}, {kw}"
        print(f"== repaired shapes ({title}), {REPAIR_BATCH} examples, vocab {REPAIR_VOCAB}")
        cfg = TrainConfig(model=model, bf16=True, vocab_size=REPAIR_VOCAB, embed_dim=dim,
                          batch_size=REPAIR_BATCH, seed=SEED, **kw)
        schema = build_schema(cfg)
        engine = Engine(build_model(model, schema, **cfg.model_kwargs()))
        b = next(iter(SyntheticSource(schema, batch_size=REPAIR_BATCH, seed=31)))
        state = engine.init(seed=SEED, device=dev)
        liven(state, gen, 10.0, dim)
        with tempfile.TemporaryDirectory() as art:
            export_model(art, cfg, engine, state)
            del state
            pred = load_predictor(art, device="cuda")
            for k in serve_route:
                k.launches = 0
            got = pred.predict_logits(b.dense, b.ids)
            launched = {k.__name__: k.launches for k in serve_route}
            print(f"serving launches: {launched}")
            for k, want in serve_route.items():
                check((k.launches > 0) is want, f"{title}: serving {'launches' if want else 'skips'} {k.__name__}")
            cpu = load_predictor(art, device="cpu").predict_logits(b.dense, b.ids)
        check(bool(np.all(np.isfinite(got))), f"{title}: finite logits")
        err, scale = rel_err(torch.as_tensor(got), torch.as_tensor(cpu))
        print(f"GPU vs CPU logits: max err {err:.6g}, max |ref| {scale:.6g}, tol {LOGIT_REL_TOL * scale:.6g}")
        check(err <= LOGIT_REL_TOL * scale, f"{title}: GPU logits match the CPU plain path")
        route = {**serve_route, **train_route}
        for k in route:
            k.launches = 0
        batch = tuple(torch.as_tensor(a, device=dev) for a in (b.dense, b.ids, b.labels))
        one_step_check(engine, engine.init(seed=SEED, device=dev), batch, gen, 10.0, dim)
        print(f"training launches: { {k.__name__: k.launches for k in route} }")
        for k, want in route.items():
            check((k.launches > 0) is want, f"{title}: the step {'launches' if want else 'skips'} {k.__name__}")


def adam_dense_check(engine3, ids, card: str, gen: torch.Generator) -> None:
    """One dense-Adam table update (``"adam_dense"``: plain PyTorch ops, as
    the JAX package's XLA route) on the card, twice from one state, and the
    same update on the CPU."""
    from recmodels_tpu_torch.embedding.optim import apply_updates, get_sparse_optimizer

    print("== dense Adam (adam_dense) on the 2,600,960 x 16 table")
    dev = torch.device("cuda")
    opt = get_sparse_optimizer("adam_dense")
    coll = engine3.collections["emb"]
    (grp,) = coll.groups
    gids = coll.group_row_ids(ids)[grp.name]
    shape = (grp.alloc_rows, DIM)
    mom = torch.randn(shape, generator=gen, device=dev) * 1e-3
    start = [torch.randn(shape, generator=gen, device=dev) * 0.05, mom, mom * mom * 10.0 + 1e-10]
    grads = (torch.randn((gids.numel(), DIM), generator=gen, device=dev) * 0.01).to(torch.bfloat16)
    step, lr = torch.tensor(30, dtype=torch.int32), torch.tensor(1e-2)

    def run(device):
        t, m, v = (x.to(device, copy=True) for x in start)
        apply_updates(opt, t, {"m": m, "v": v}, gids.to(device), grads.to(device), step.to(device),
                      lr.to(device))
        return t, m, v

    runs = [run(dev), run(dev)]
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(*runs)), "adam_dense on the card repeats bit for bit")
    cpu = run("cpu")
    untouched = torch.ones(shape[0], dtype=torch.bool)
    untouched[gids.reshape(-1).long().cpu()] = False
    for name, got, want, old in zip(("table", "m", "v"), runs[0], cpu, start):
        got, old = got.cpu(), old.cpu()
        err = (got - want).abs().max().item()
        change = (want - old).abs().max().item()
        check(err <= DENSE_ADAM_REL_TOL * change,
              f"adam_dense {name} on the card within {DENSE_ADAM_REL_TOL} of the CPU's change "
              f"(err {err:.6g}, change {change:.6g})")
        check(not torch.equal(got[untouched], old[untouched]), f"adam_dense {name}: untouched rows move")
        print(f"adam_dense {name}: max err {err:.6g} against a largest change of {change:.6g}")
    t, m, v = runs[0]
    step, lr = step.to(dev), lr.to(dev)
    ms = time_ms(lambda: apply_updates(opt, t, {"m": m, "v": v}, gids, grads, step, lr), iters=10)
    print(f"adam_dense update of the 2,600,960 x 16 table from {gids.numel()} ids: {ms:.4f} ms on {card} "
          f"(index_put_ accumulate: two runs bit-identical)")



# ------------------------- slice 9: the sharded path in an NCCL world of one
def states_differ(a, b) -> str | None:
    """The path of the first tensor where two states differ, or None."""
    for (name, x), (_, y) in zip(named_tensors(a), named_tensors(b)):
        if not torch.equal(x, y):
            return name
    return None


def step_part(name: str) -> str:
    """The part of a training step a kernel or copy belongs to, by name."""
    n = name.lower()
    for part, keys in (("row gather (#1)", ("gather_tiles", "gather_values")), ("sparse update", ("sorted_update",)),
                       ("nccl", ("nccl",)), ("copies", ("memcpy", "memset")), ("searchsorted", ("searchsorted",)),
                       ("index gathers", ("index", "gather")), ("sorts", ("sort",)),
                       ("elementwise and reductions", ("elementwise", "reduce", "foreach"))):
        if any(k in n for k in keys):
            return part
    return "the rest"


def compare_step_profiles(sharded_fn, local_fn, card: str) -> None:
    """The kernel time per replay of the sharded and the local captured
    step, by part (``step_part``) and, for the kernels that differ most,
    by name."""
    by_name = {k: launch_split(fn, calls=10, full_names=True) for k, fn in (("sharded", sharded_fn),
                                                                          ("local", local_fn))}
    parts = {k: {} for k in by_name}
    for k, names in by_name.items():
        for name, ms in names.items():
            parts[k][step_part(name)] = parts[k].get(step_part(name), 0.0) + ms
    for part in sorted(set(parts["sharded"]) | set(parts["local"]), key=lambda p: -parts["sharded"].get(p, 0.0)):
        a, b = parts["sharded"].get(part, 0.0), parts["local"].get(part, 0.0)
        print(f"step parts: {part}: sharded {a:.4f} ms, local {b:.4f} ms ({a - b:+.4f}) per replay on {card}")
    print(f"step parts: kernels and copies, sharded {sum(parts['sharded'].values()):.4f} ms, local "
          f"{sum(parts['local'].values()):.4f} ms per replay, on {card}")
    names = set(by_name["sharded"]) | set(by_name["local"])
    diffs = sorted(names, key=lambda n: -abs(by_name["sharded"].get(n, 0.0) - by_name["local"].get(n, 0.0)))
    for name in diffs[:16]:
        a, b = by_name["sharded"].get(name, 0.0), by_name["local"].get(name, 0.0)
        print(f"step kernels: {a - b:+.4f} ms (sharded {a:.4f}, local {b:.4f}) {name[:110]}")


def sharded_phase(engine, engine3, schema, report: dict, card: str) -> tuple[dict[str, int], dict[str, int]]:
    """Phase l: the sharded path (``parallel/``) in the NCCL process group of
    one rank on the card that ``main`` formed, against the local engine;
    returns the launches of the flagship's and of the slice-3 path's sharded
    steps (the counts are set to 0 just before each sharded step and read
    just after)."""
    import torch.distributed as dist

    from recmodels_tpu_torch.data import SyntheticSource
    from recmodels_tpu_torch.embedding.gather import gather_rows, gather_rows_reference
    from recmodels_tpu_torch.embedding.update import (
        sorted_adagrad_update, sorted_adagrad_update_reference, sorted_adam_update,
    )
    from recmodels_tpu_torch.models import build_model
    from recmodels_tpu_torch.ops.cuda.interactions_cuda import (
        cin2_backward, cin2_forward, cin_layer_backward, cin_layer_forward, split_fused_rows,
        split_fused_rows_backward, transpose_minor2,
    )
    from recmodels_tpu_torch.parallel import (
        build_parallel_engine, build_parallel_scan, build_parallel_steps, make_mesh, shard_state,
    )
    from recmodels_tpu_torch.train.metrics import auc_init
    from recmodels_tpu_torch.utils.config import TrainConfig

    dev = torch.device("cuda", 0)
    mesh = make_mesh(1)
    print(f"== sharded (phase l): an NCCL world of {mesh.size} on {mesh.device}, NCCL "
          f"{'.'.join(map(str, torch.cuda.nccl.version()))}; full-width bf16 xDeepFM, capacity factor "
          f"{SHARDED_CAPACITY}")
    check(mesh.device == dev, f"the NCCL mesh's device is {dev}")
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)  # phase l's own draws
    cfg = TrainConfig(model="xdeepfm", bf16=True, vocab_size=VOCAB, embed_dim=DIM, cin_sizes=CIN, hidden=HIDDEN,
                      batch_size=BATCH, seed=SEED)

    def flagship(mesh_, capacity):
        return build_parallel_engine(build_model(cfg.model, schema, **cfg.model_kwargs()), mesh_,
                                     capacity_factor=capacity)

    sharded = flagship(mesh, SHARDED_CAPACITY)
    (grp,) = sharded.collections["emb"].groups
    rows = sharded.tables.padded_rows("emb", grp)
    check(rows == grp.alloc_rows, f"padded rows {rows} equal the local table's {grp.alloc_rows} at world 1")
    cap = sharded.tables._capacity(BATCH * schema.n_slots)
    print(f"table {rows} x {DIM + 1}; {BATCH * schema.n_slots} ids a step, a bucket of {cap} (the owner's "
          f"gather and update run on {cap} positions, {cap - BATCH * schema.n_slots} of them sentinels)")

    def stream(seed, n):
        src = iter(SyntheticSource(schema, batch_size=BATCH, seed=seed))
        return [tuple(torch.as_tensor(a, device=dev) for a in (b.dense, b.ids, b.labels))
                for b in (next(src) for _ in range(n))]

    batches = stream(11, SHARDED_STEPS)  # slice 2's training stream

    # 1. lockstep: the local engine and the sharded one from one global state
    start = sharded.init(seed=SEED, device=dev)
    liven(start, gen)
    local = to_device(start, dev)  # at world 1 the global state is a local one
    eager = shard_state(start, mesh)
    kernels = (gather_rows, split_fused_rows, cin2_forward, sorted_adagrad_update, split_fused_rows_backward,
               cin2_backward)
    launches = {k.__name__: 0 for k in kernels}
    losses = []
    t0 = time.perf_counter()
    for k, (dense, ids, labels) in enumerate(batches):
        local, ml = engine.train_step(local, dense, ids, labels)
        for kern in kernels:
            kern.launches = 0
        eager, ms = sharded.train_step(eager, dense, ids, labels)
        for kern in kernels:
            check(kern.launches >= 1, f"{kern.__name__} launched on sharded step {k}")
            launches[kern.__name__] += kern.launches
        check(int(ms["overflow"]) == 0, f"overflow 0 on sharded step {k} ({int(ms['overflow'])})")
        check(torch.equal(ms["loss"], ml["loss"]),
              f"sharded loss of step {k} equals the local step's bit for bit ({ms['loss'].item()!r}, "
              f"{ml['loss'].item()!r})")
        losses.append(ms["loss"])
    wall = time.perf_counter() - t0
    diff = states_differ(eager, local)
    check(diff is None, f"the sharded state after {SHARDED_STEPS} steps equals the local one (first difference: "
          f"{diff})")
    print(f"lockstep: {SHARDED_STEPS} sharded steps bit for bit the local engine's (every loss; tables, "
          f"accumulators and dense state at the end), overflow 0 on every step; {wall:.3f} s for both runs")
    print(f"sharded launches over {SHARDED_STEPS} steps: {launches}")
    print("sharded losses: " + " ".join(f"{v:.5f}" for v in torch.stack(losses).tolist()))

    # 2. the captured steps (NCCL's collectives inside the graph) and scan
    train, evaluate = build_parallel_steps(sharded, mesh)
    captured = shard_state(start, mesh)
    for k, batch in enumerate(batches):
        captured, mc = train(captured, *batch)
        check(torch.equal(mc["loss"], losses[k]) and int(mc["overflow"]) == 0,
              f"captured sharded step {k}: loss bit for bit eager's, overflow 0")
    check(train.captured.graphs == 1, f"one graph captured ({train.captured.graphs})")
    diff = states_differ(captured, eager)
    check(diff is None, f"the captured sharded state equals the eager one (first difference: {diff})")
    scanned = shard_state(start, mesh)
    stacked = [torch.stack([b[j] for b in batches[:SHARDED_SCAN]]) for j in range(3)]
    scanned, m = build_parallel_scan(sharded, mesh)(scanned, *stacked)
    check(torch.equal(m["losses"], torch.stack(losses[:SHARDED_SCAN])) and int(m["overflow"]) == 0,
          f"build_parallel_scan of {SHARDED_SCAN} steps: losses bit for bit the eager steps', overflow 0")
    print(f"captured: build_parallel_steps' graph (NCCL all_to_all_single and all_reduce captured) over "
          f"{SHARDED_STEPS} steps and build_parallel_scan over {SHARDED_SCAN}: bit for bit the eager steps")
    del scanned, stacked, captured

    # 3. eval of the trained state against the local engine's captured eval
    auc_s, auc_l = auc_init(device=dev), auc_init(device=dev)
    es = engine.jit_eval_step()
    for batch in stream(EVAL_SEED, SHARDED_EVAL_BATCHES):
        evaluate(eager, auc_s, *batch)
        es(local, auc_l, *batch)
    check(all(torch.equal(a, b) for a, b in zip(auc_s, auc_l)),
          "build_parallel_steps' eval AUC state equals the local jit_eval_step's bit for bit")
    print(f"eval: {SHARDED_EVAL_BATCHES} held-out batches, the sharded (captured) AUC state bit for bit the local "
          f"jit_eval_step's ({int(auc_s.count)} examples)")

    # 5. overflow at a capacity factor of 0.05 against the CPU's plain
    # sharded engine (a gloo world of one beside the NCCL one)
    dense, ids, labels = batches[0]
    low = flagship(mesh, OVERFLOW_CAPACITY)
    got, ovf = low.tables.gather_with_stats(eager.emb_params, low._group_ids(ids))
    cpu_mesh = make_mesh(1, group=dist.new_group(backend="gloo"))
    low_cpu = flagship(cpu_mesh, OVERFLOW_CAPACITY)
    got_cpu, ovf_cpu = low_cpu.tables.gather_with_stats(to_device(eager.emb_params, "cpu"),
                                                        low_cpu._group_ids(ids.cpu()))
    want = engine.tables.gather(local.emb_params, engine._group_ids(ids), torch.float32)
    r, w = got["emb"]["d17"].reshape(-1, DIM + 1), want["emb"]["d17"].reshape(-1, DIM + 1)
    zero = ~r.any(dim=1)
    check(int(ovf) == int(ovf_cpu) > 0, f"overflow count {int(ovf)} equals the CPU plain sharded engine's "
          f"{int(ovf_cpu)}")
    check(not bool((~w.any(dim=1)).any()) and int(zero.sum()) == int(ovf),
          f"the {int(ovf)} overflowed lookups, and only they, are zero rows")
    check(torch.equal(r[~zero], w[~zero]), "the other rows equal the local gather's bit for bit")
    check(torch.equal(got_cpu["emb"]["d17"], got["emb"]["d17"].cpu()), "the card's rows equal the CPU's")
    print(f"overflow at capacity factor {OVERFLOW_CAPACITY}: a bucket of {low.tables._capacity(ids.numel())}, "
          f"{int(ovf)} lookups dropped (the CPU's plain sharded engine: {int(ovf_cpu)}), each a zero row; the "
          f"other rows the local gather's bit for bit")
    del got, got_cpu, want, r, w, zero, low, low_cpu

    # 6. times: (c') of the sharded step beside the local one, the step's
    # parts by the profiler, and the owner's #1 and #4 at cap ids
    dense, ids, labels = batches[-1]
    ts_local = engine.jit_train_step()
    local_ms = time_ms(lambda: ts_local(local, dense, ids, labels), iters=10)
    sharded_ms = time_ms(lambda: train(eager, dense, ids, labels), iters=10)
    print(f"(c') sharded step at {BATCH}: {sharded_ms:.4f} ms per step, local (c') {local_ms:.4f} ms "
          f"(CUDA events, 10 back-to-back calls of each captured step), {sharded_ms - local_ms:+.4f} ms, "
          f"on {card}")
    compare_step_profiles(lambda: train(eager, dense, ids, labels), lambda: ts_local(local, dense, ids, labels),
                          card)
    # the exchange's stages, eager, by their kernels' device time: the plan
    # (sort, bounds, bucket maps, hop 1, the owner's stream), the gather's
    # route (#1 at cap ids, hop 2, the readback) and the update's (the
    # grads' bucket gather, their hop, #4), beside the local gather and
    # update of the same batch
    gids_s, gids_l = sharded._group_ids(ids), engine._group_ids(ids)
    plans = sharded.tables.plan(gids_s)
    g_rows = {"emb": {"d17": (torch.randn((BATCH, schema.n_slots, DIM + 1), generator=gen, device=dev)
                              * 1e-3).to(torch.bfloat16)}}
    lr_t, step_t = torch.tensor(1e-2, device=dev), eager.step.clone()
    stages = (
        ("plan", lambda: sharded.tables.plan(gids_s), None),
        ("gather", lambda: sharded.tables.gather(eager.emb_params, plans, torch.bfloat16),
         lambda: engine.tables.gather(local.emb_params, gids_l, torch.bfloat16)),
        ("update", lambda: sharded.tables.apply_grads(eager.emb_params, eager.emb_opt, plans, g_rows, step_t, lr_t),
         lambda: engine.tables.apply_grads(local.emb_params, local.emb_opt, gids_l, g_rows, step_t, lr_t)),
    )
    for stage, fn_s, fn_l in stages:
        a = device_ms(fn_s)
        b = device_ms(fn_l) if fn_l is not None else 0.0
        fmt = lambda x: "not measured" if x is None else f"{x:.4f} ms"  # noqa: E731
        print(f"exchange stage {stage}: sharded {fmt(a)}, local {fmt(b)} of kernels a call (eager, "
              f"torch.profiler) on {card}")
    del plans, g_rows
    plan = sharded.tables.plan(sharded._group_ids(ids))["emb"]["d17"]
    table = eager.emb_params["emb"]["d17"]
    owner_ids, owner_stream = plan.gather_ids, plan.stream_ids
    ref = gather_rows_reference(table, owner_ids, torch.bfloat16)
    check(torch.equal(gather_rows(table, owner_ids, torch.bfloat16), ref), "owner's gather bit for bit its plain "
          "version at cap ids")
    touched = torch.unique(owner_ids).numel()
    owner = {"owner_max_abs_err": 0.0}
    owner["owner_bound_ms"], owner["owner_bound_by"] = bound_ms(touched * (DIM + 1) * 4 + cap * 4
                                                                + ref.numel() * 2)
    owner.update(short_times(lambda: gather_rows(table, owner_ids, torch.bfloat16),
                             lambda: gather_rows_reference(table, owner_ids, torch.bfloat16),
                             lambda: torch.index_select(table, 0, owner_ids).to(torch.bfloat16), "owner_"))
    report["gather_rows"].update(owner)
    report["gather_rows"]["shapes"] += ("; owner_: the sharded owner's gather at world 1, cap = 532,480 ids "
                                        "(the batch's 425,984 sorted, then sentinels clamped to the last row)")
    grads = (torch.randn((cap, DIM + 1), generator=gen, device=dev) * 0.01).to(torch.bfloat16)
    t_up, a_up = table.clone(), eager.emb_opt["emb"]["d17"]["acc"].clone()
    eps = 1e-8
    t_cpu, a_cpu = t_up.cpu(), a_up.cpu()
    sorted_adagrad_update_reference(t_cpu, a_cpu, owner_stream.cpu(), grads.cpu(), lr_t.cpu(), eps)
    sorted_adagrad_update(t_up, a_up, owner_stream, grads, lr_t, eps)
    err = max((t_up.cpu() - t_cpu).abs().max().item(), (a_up.cpu() - a_cpu).abs().max().item())
    check(err == 0.0, f"owner's sparse update at cap ids with its sentinel tail bit for bit the CPU's ({err})")
    # the kernel reads the grads of real ids only: the sentinel tail's are
    # skipped with their ids
    real = int((owner_stream < rows).sum())
    touched = torch.unique(owner_stream[owner_stream < rows]).numel()
    upd = {"owner_max_abs_err": err}
    upd["owner_bound_ms"], upd["owner_bound_by"] = bound_ms(cap * 4 + real * (DIM + 1) * 2 + touched * (DIM + 1) * 16)
    upd.update(short_times(lambda: sorted_adagrad_update(t_up, a_up, owner_stream, grads, lr_t, eps),
                           lambda: sorted_adagrad_update_reference(t_up, a_up, owner_stream, grads, lr_t, eps),
                           adagrad_library_step(t_up, owner_stream, grads, 1e-2, eps), "owner_"))
    report["sorted_adagrad_update"].update(upd)
    report["sorted_adagrad_update"]["shapes"] += ("; owner_: the sharded owner's stream at world 1, cap = "
                                                  "532,480 positions, the last 106,496 sentinels")
    for name, r_ in (("gather_rows", owner), ("sorted_adagrad_update", upd)):
        print(f"owner's {name} at {cap} positions: {r_['owner_ms']:.4f} ms cold, warm "
              f"{r_['owner_warm_ms'] if r_['owner_warm_ms'] is None else format(r_['owner_warm_ms'], '.4f')} ms; "
              f"plain {r_['owner_plain_ms']:.4f} ms, library {r_['owner_library_ms']:.4f} ms, bound "
              f"{r_['owner_bound_ms']:.4f} ms ({r_['owner_bound_by']}) on {card}")
    del t_up, a_up, t_cpu, a_cpu, grads, plan, ref, eager, local, start

    # 4. lazy Adam: the slice-3 configuration, sharded against local
    cfg3 = TrainConfig(model="xdeepfm", bf16=True, vocab_size=VOCAB, embed_dim=DIM, cin_sizes=CIN3,
                       hidden=HIDDEN, batch_size=BATCH, seed=SEED)
    sharded3 = build_parallel_engine(build_model(cfg3.model, schema, **cfg3.model_kwargs()), mesh,
                                     dense_lr=engine3.dense_lr, emb_lr=engine3.emb_lr, sparse_optimizer="adam",
                                     capacity_factor=SHARDED_CAPACITY, fuse_wide=False)
    start3 = sharded3.init(seed=SEED, device=dev)
    liven(start3, gen)
    local3, eager3 = to_device(start3, dev), shard_state(start3, mesh)
    del start3
    kernels3 = (gather_rows, transpose_minor2, cin_layer_forward, cin_layer_backward, sorted_adam_update)
    launches3 = {k.__name__: 0 for k in kernels3}
    for k, batch in enumerate(stream(13, SHARDED3_STEPS)):  # slice 3's training stream
        local3, ml = engine3.train_step(local3, *batch)
        for kern in kernels3:
            kern.launches = 0
        eager3, ms = sharded3.train_step(eager3, *batch)
        check(sorted_adam_update.launches >= 2, f"lazy Adam launched on both tables on sharded step {k}")
        for kern in kernels3:
            check(kern.launches >= 1, f"{kern.__name__} launched on sharded slice-3 step {k}")
            launches3[kern.__name__] += kern.launches
        check(torch.equal(ms["loss"], ml["loss"]) and int(ms["overflow"]) == 0,
              f"sharded slice-3 step {k}: loss bit for bit the local step's, overflow 0")
    diff = states_differ(eager3, local3)
    check(diff is None, f"the sharded slice-3 state equals the local one (first difference: {diff})")
    print(f"lazy Adam (slice 3, CIN{CIN3}, unfused wide table): {SHARDED3_STEPS} sharded steps bit for bit the "
          f"local engine's; launches {launches3}")
    return launches, launches3


# ---------------------- slice 10: several processes and what rides on them
def timed_s(fn):
    """(fn(), its wall seconds, the card synchronised before and after)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def multihost_phase(engine, schema, work: str, card: str) -> dict[str, int]:
    """Phase m, in the NCCL world of one ``multihost.initialize`` formed:
    the full-width bf16 flagship trained RESTORE_STEPS captured steps on the
    local engine and checkpointed; ``restore_cross_geometry`` into the
    world-1 sharded engine (its state and logits the local ones bit for
    bit); SHARDED_RESUME_STEPS eager sharded steps (every kernel of the step
    on each; their launches returned, the counts set to 0 just before and
    read just after); the sharded save through ``gather_state`` (its stall:
    the gather and the host copy, beside the local save's in this run); a
    restore into the local engine (the gathered state bit for bit); export
    from the sharded state (the artifact the local restore's, byte for
    byte); then the geometry change at vocab GEOMETRY_VOCAB: a checkpoint of
    a world of GEOMETRY_WORLD's padded rows into the world-1 sharded engine
    and back to local."""
    from recmodels_tpu_torch.data import SyntheticSource, criteo_schema
    from recmodels_tpu_torch.embedding.gather import gather_rows
    from recmodels_tpu_torch.embedding.update import sorted_adagrad_update
    from recmodels_tpu_torch.models import build_model
    from recmodels_tpu_torch.ops.cuda.interactions_cuda import (
        cin2_backward, cin2_forward, split_fused_rows, split_fused_rows_backward,
    )
    from recmodels_tpu_torch.parallel import Mesh, build_parallel_engine, gather_state, make_mesh, shard_state
    from recmodels_tpu_torch.serve import export_model
    from recmodels_tpu_torch.train.checkpoint import CheckpointManager
    from recmodels_tpu_torch.train.engine import Engine
    from recmodels_tpu_torch.utils.config import TrainConfig

    mesh = make_mesh(1)
    dev = mesh.device
    print(f"== several processes (phase m): multihost.initialize's NCCL world of {mesh.size} on {dev}; "
          f"full-width bf16 xDeepFM, capacity factor {SHARDED_CAPACITY}")
    cfg = TrainConfig(model="xdeepfm", bf16=True, vocab_size=VOCAB, embed_dim=DIM, cin_sizes=CIN, hidden=HIDDEN,
                      batch_size=BATCH, seed=SEED, capacity_factor=SHARDED_CAPACITY)
    sharded = build_parallel_engine(build_model(cfg.model, schema, **cfg.model_kwargs()), mesh,
                                    capacity_factor=SHARDED_CAPACITY)
    src = iter(SyntheticSource(schema, batch_size=BATCH, seed=19))
    batches = [tuple(torch.as_tensor(a, device=dev) for a in (b.dense, b.ids, b.labels))
               for b in (next(src) for _ in range(RESTORE_STEPS + SHARDED_RESUME_STEPS + 1))]

    # 1. the local flagship, trained and checkpointed
    local = engine.init(seed=SEED, device=dev)
    ts = engine.jit_train_step()
    for b in batches[:RESTORE_STEPS]:
        local, m = ts(local, *b)
    check(bool(torch.isfinite(m["loss"])), f"local loss after {RESTORE_STEPS} captured steps finite")
    local_dir = os.path.join(work, "local")
    mgr = CheckpointManager(local_dir)
    _, local_stall = timed_s(lambda: mgr.save(RESTORE_STEPS, local, {"step": RESTORE_STEPS}))
    mgr.wait()
    size = sum(os.path.getsize(os.path.join(local_dir, str(RESTORE_STEPS), f))
               for f in os.listdir(os.path.join(local_dir, str(RESTORE_STEPS))))

    # 2. into the world-1 sharded engine
    target = shard_state(sharded.init(seed=SEED + 1, device=dev), mesh)
    (state, data), restore_s = timed_s(
        lambda: CheckpointManager(local_dir, mesh=mesh).restore_cross_geometry(target))
    diff = states_differ(state, local)
    check(state is target and data == {"step": RESTORE_STEPS} and diff is None,
          f"restore_cross_geometry into the world-1 sharded engine: the local state bit for bit (first "
          f"difference: {diff})")
    dense, ids, _ = batches[-1]
    with torch.no_grad():
        check(torch.equal(sharded.logits(state, dense, ids), engine.logits(local, dense, ids)),
              "the restored sharded engine's logits equal the local engine's bit for bit")
    print(f"restore: {size / 2**20:.1f} MiB, local -> world-1 sharded (restore_cross_geometry) "
          f"{1e3 * restore_s:.1f} ms; state and logits bit for bit the local engine's, on {card}")

    # 3. sharded steps from the restored state
    kernels = (gather_rows, split_fused_rows, cin2_forward, sorted_adagrad_update, split_fused_rows_backward,
               cin2_backward)
    for kern in kernels:
        kern.launches = 0
    losses = []
    for b in batches[RESTORE_STEPS:RESTORE_STEPS + SHARDED_RESUME_STEPS]:
        state, ms = sharded.train_step(state, *b)
        check(int(ms["overflow"]) == 0, "overflow 0 on a restored sharded step")
        losses.append(ms["loss"])
    launches = {k.__name__: k.launches for k in kernels}
    for name, n in launches.items():
        check(n >= SHARDED_RESUME_STEPS, f"{name} launched on every restored sharded step ({n} in "
              f"{SHARDED_RESUME_STEPS})")
    check(bool(torch.isfinite(torch.stack(losses)).all()), "restored sharded losses finite")
    print(f"{SHARDED_RESUME_STEPS} sharded steps from the restore: launches {launches}; losses "
          + " ".join(f"{v:.5f}" for v in torch.stack(losses).tolist()))

    # 4. the sharded save: gather_state, then the host copy
    glob, gather_s = timed_s(lambda: gather_state(state, mesh))
    sharded_dir = os.path.join(work, "sharded")
    smgr = CheckpointManager(sharded_dir, mesh=mesh)
    step = RESTORE_STEPS + SHARDED_RESUME_STEPS
    _, stall = timed_s(lambda: smgr.save(step, state, {"step": step}))
    _, write_s = timed_s(smgr.wait)
    print(f"sharded save: {1e3 * stall:.1f} ms stall (gather_state {1e3 * gather_s:.1f} ms of it, alone) + "
          f"{1e3 * write_s:.1f} ms to write (background); the local save of the same {size / 2**20:.1f} MiB "
          f"stalled {1e3 * local_stall:.1f} ms in this run, on {card}")

    # 5. back into the local engine
    (back, _), back_s = timed_s(
        lambda: CheckpointManager(sharded_dir).restore_cross_geometry(engine.init(seed=SEED + 2, device=dev)))
    diff = states_differ(back, glob)
    check(diff is None, f"the sharded checkpoint restored into the local engine equals the gathered state bit "
          f"for bit (first difference: {diff})")
    del glob

    # 6. export from the sharded state, and from the local restore
    _, export_s = timed_s(lambda: export_model(os.path.join(work, "art-sharded"), cfg, sharded, state))
    export_model(os.path.join(work, "art-local"), cfg, engine, back)
    for name in ("params.npz", "model.json"):
        with open(os.path.join(work, "art-sharded", name), "rb") as f1, \
                open(os.path.join(work, "art-local", name), "rb") as f2:
            check(f1.read() == f2.read(), f"the sharded export's {name} equals the local restore's byte for byte")
    print(f"world-1 sharded -> local restore {1e3 * back_s:.1f} ms (the gathered state bit for bit); export "
          f"from the sharded state {1e3 * export_s:.1f} ms, its artifact the local restore's byte for byte, "
          f"on {card}")
    del state, back, local, target

    # 7. a geometry change at vocab GEOMETRY_VOCAB: world 4's padded rows -> world 1 -> local
    schema7 = criteo_schema(vocab_size=GEOMETRY_VOCAB, embed_dim=DIM)
    model7 = build_model(cfg.model, schema7, **cfg.model_kwargs())
    local7 = Engine(model7)
    sharded7 = build_parallel_engine(model7, mesh, capacity_factor=SHARDED_CAPACITY)
    src7 = iter(SyntheticSource(schema7, batch_size=GEOMETRY_BATCH, seed=23))
    b7 = [tuple(torch.as_tensor(a, device=dev) for a in (b.dense, b.ids, b.labels)) for b in (next(src7) for _ in range(3))]
    st7 = local7.init(seed=SEED, device=dev)
    for b in b7[:2]:
        st7, _ = local7.train_step(st7, *b)
    m7 = CheckpointManager(os.path.join(work, "g-local"))
    m7.save(2, st7, {"step": 2})
    m7.wait()
    blocks = []
    for r in range(GEOMETRY_WORLD):  # each rank's block of a world of 4, by the manager's fit
        fake = Mesh(group=None, size=GEOMETRY_WORLD, rank=r, device=dev)
        eng4 = build_parallel_engine(model7, fake, capacity_factor=SHARDED_CAPACITY)
        blocks.append(m7.restore_cross_geometry(shard_state(eng4.init(seed=SEED, device=dev), fake), mesh=fake)[0])
    (g7,) = sharded7.collections["emb"].groups
    rows4 = eng4.tables.padded_rows("emb", g7)
    world4 = blocks[0]._replace(
        emb_params={"emb": {g7.name: torch.cat([b.emb_params["emb"][g7.name] for b in blocks])}},
        emb_opt={"emb": {g7.name: {k: torch.cat([b.emb_opt["emb"][g7.name][k] for b in blocks])
                                   for k in blocks[0].emb_opt["emb"][g7.name]}}})
    check(world4.emb_params["emb"][g7.name].shape[0] == rows4 > g7.alloc_rows,
          f"a world of {GEOMETRY_WORLD} pads {g7.alloc_rows} rows to {rows4}")
    m4 = CheckpointManager(os.path.join(work, "g-world4"))
    m4.save(2, world4, {"step": 2})
    m4.wait()
    del blocks, world4
    got7, _ = CheckpointManager(os.path.join(work, "g-world4"), mesh=mesh).restore_cross_geometry(
        shard_state(sharded7.init(seed=SEED + 1, device=dev), mesh))
    diff = states_differ(got7, st7)
    check(diff is None, f"world {GEOMETRY_WORLD} ({rows4} rows) -> world-1 sharded ({g7.alloc_rows}): the local "
          f"state bit for bit (first difference: {diff})")
    dense7, ids7, _ = b7[2]
    with torch.no_grad():
        check(torch.equal(sharded7.logits(got7, dense7, ids7), local7.logits(st7, dense7, ids7)),
              "its logits the local engine's bit for bit")
    m1 = CheckpointManager(os.path.join(work, "g-world1"), mesh=mesh)
    m1.save(2, got7, {"step": 2})
    m1.wait()
    back7, _ = CheckpointManager(os.path.join(work, "g-world1")).restore_cross_geometry(
        local7.init(seed=SEED + 2, device=dev))
    check(states_differ(back7, st7) is None, "world-1 sharded -> local: the local state bit for bit")
    print(f"geometry at vocab {GEOMETRY_VOCAB}: local ({g7.alloc_rows} rows) -> world {GEOMETRY_WORLD} "
          f"({rows4}) -> world-1 sharded ({g7.alloc_rows}) -> local, bit for bit, logits equal")
    return launches


def graft_phase(card: str) -> None:
    """Phase n: ``graft_entry_torch``: ``entry()``'s forward on the card
    (finite, the CPU plain path's on the same state within LOGIT_REL_TOL of
    its largest logit) and ``dryrun_multichip(1)``, one rank in an NCCL
    world of its own."""
    import graft_entry_torch

    print("== graft entry (phase n)")
    forward, (state, dense, ids) = graft_entry_torch.entry()
    with torch.no_grad():
        got = forward(state, dense, ids)
        want = forward(to_device(state, "cpu"), dense.cpu(), ids.cpu())
    err = (got.cpu() - want).abs().max().item()
    check(got.shape == (256,) and bool(torch.isfinite(got).all()) and err <= LOGIT_REL_TOL * want.abs().max().item(),
          f"entry()'s forward: 256 finite logits, the CPU plain path's within {LOGIT_REL_TOL} of the largest "
          f"({err:.3g})")
    print(f"entry(): xDeepFM bf16 at vocab 10,000, dim 16, CIN(128,128), DNN(400,400), batch 256: max |card - "
          f"CPU| {err:.3g}")
    _, s = timed_s(lambda: graft_entry_torch.dryrun_multichip(1))
    print(f"dryrun_multichip(1): {s:.1f} s, the rank's start included, on {card}")


if __name__ == "__main__":
    sys.exit(main())
