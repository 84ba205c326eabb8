#!/usr/bin/env python3
"""The kernel tables of PERF.md section 6: every hand-written CUDA kernel of
the PyTorch/CUDA port against its plain PyTorch version on one NVIDIA GPU,
at every instance the port's paths launch, with its times and its bound.

    python3 chip_smoke.py            # from the repository root, one card

It prints, in order:
  1. card:     the card's name and power limit, as nvidia-smi reports them;
  2. build:    the kernels of recmodels_tpu_torch/csrc/, built into
               recmodels_tpu_torch/_build/ (reused when the sources are
               unchanged);
  3. kernels:  each kernel against its plain version (its largest error and
               the tolerance; most bit for bit), at the flagship shapes
               (xDeepFM: B = 16,384, 26 slots of 1e5 ids, dim 16 plus the
               fused first-order column, CIN(128,128)) and at each other
               instance a path launches: the gather at f32 rows, 16, 1 and
               33 columns, requests of 26 and 26,000 ids and LR's f32 column,
               and at the sharded owner's 532,480 positions; both fanouts in
               bf16 and f32; the fused CIN forward and backward at CIN(128,
               128) and at the benchmark's CIN(200,200) zero-padded to 208;
               the sparse Adagrad update at d17, PNN's d16, dim 1 with bf16
               and LR's f32 grads, the owner's stream and DLRM-DCNv2's d128
               (its pooled grads read through the bags and the expanded
               stream); lazy Adam at d16 and dim 1; the CIN layer forward at
               layers 1 and 2 in bf16 and f32, its backward, the transpose;
               the FM term on the stride-17 view (DeepFM bf16, FM f32); the
               DCN cross stack in bf16 and f32 (each with a SHA-256 of its
               output); the batch kernel of in-graph data generation at steps
               0, 1 and 2^31 - 1; the pooled bag gather at the DLRM-DCNv2
               cell's batch; the bf16 MLP's epilogues forward and back at
               its widest layer, [16,384, 1,024]; the Wukong FM kernels
               forward and back at the Wukong cell's layers (n 32 and
               layer 1's 27) and its residual LayerNorm forward and back.
               Beside each: the plain version's time, a
               library call's where one PyTorch call computes the same
               function, and the bound (benchmark.counts.bound_ms: the larger
               of bytes over the memory rate and operations over the peak
               rate, both from benchmark/peaks.json by the card's name; the
               batch kernel's integer operations over PEAK_INT32_OP_PER_S);
               the gather and the updates also the sector bound, the
               distinct 32-byte sectors their inputs and outputs touch over
               the memory rate. A kernel shorter than about 0.1 ms is timed
               with a cold L2, warm by torch.profiler and by CUDA events
               (SHORT_TIMING); the rest by CUDA events over back-to-back
               calls and by torch.profiler launch by launch;
  4. launches: each kernel's launches in one eager training step of each
               path at its shape: the flagship, slice 3 (CIN(128,128,128),
               an unfused wide table, lazy Adam), DeepFM, DCN, FM, f32
               xDeepFM, LR, PNN, Wide&Deep, NFM, AFM, the generated step,
               DLRM-DCNv2, Wukong and, in an NCCL world of one, the sharded flagship
               and slice 3 and the sharded flagship restored from a local
               checkpoint; and in one eager served forward (Engine.logits)
               of each unsharded path. Each of those paths also serves a
               request through the Predictor's bucket graph (bit for bit
               eager) and replays a captured step, and the flagship trains a
               few steps through cli.train under a watchdog;
  5. a JSON line {"kernels": [...]}, a row a kernel (launches_per_step from
     the first path in that order that launches it, every path's count
     beside it, launches_served_<path> each served forward's), then the
     card line again and {"ok": true, "device": {...}}.

Whole paths are checked on the card by tests/test_torch_cuda.py and timed
by the benchmark (benchmark/run.py). Any failed check raises, so the script
exits non-zero before the result line. It also exits non-zero when no CUDA
device is present, and when it stands alone, without the package beside it.
"""

from __future__ import annotations

import faulthandler
import hashlib
import json
import os
import subprocess
import sys
import time

import torch

from benchmark import counts

ROOT = os.path.dirname(os.path.abspath(__file__))

# 32-bit integer operations, which benchmark/peaks.json does not list: the
# data sheet's f32 rate (67 TFLOP/s) is 2 (an FMA) x 128 FP32 lanes an SM x
# 132 SMs x 1.98 GHz; an SM has half as many INT32 lanes, an operation each
PEAK_INT32_OP_PER_S = 16.75e12

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
SEED = 0
# the batch kernel (csrc/device_synth.cu) at these steps; a label of the
# kernel may differ from the plain version's only where its uniform lies this
# close to its probability. Its counts: examples a block; the integer
# operations of a draw (threefry2x32: 2 + 20 rounds of 3 + 5 injections of
# 3; the XOR, shift and OR of the float) and of an id's bucket weight (the
# hash's multiply-add, 3 xor-shifts, 2 multiplies, the shift); the key draws
# a block (fold_in and split for 4 threads)
SYNTH_STEPS = (0, 1, 2**31 - 1)
SYNTH_LABEL_MARGIN = 1e-6
SYNTH_ROWS = 64
INT_OPS_PER_DRAW = 80
INT_OPS_PER_ID = 11
SYNTH_KEY_DRAWS = 8
# the sharded owner's instances of #1 and #4: the flagship at a capacity
# factor of 1.25 in a world of one, its bucket the batch's ids sorted, then
# sentinels, on the last batch of the 30-step stream 11
SHARDED_CAPACITY = 1.25
OWNER_STREAM_SEED = 11
OWNER_BATCH_INDEX = 29
# the served request through each path's Predictor bucket graph; the
# flagship's steps through cli.train, which must end within CLI_LIMIT_S
# (else every thread's stack goes to stderr and the script exits non-zero)
SERVE_REQUEST = 1024
CLI_STEPS = 4
CLI_LIMIT_S = 300
# kernel vs plain on bf16 outputs: both sum in f32 in different orders and then
# round to bf16, so a value may land one bf16 step (2^-8 relative) apart; p2
# sums 3,328 such inputs. 1% of the largest magnitude covers that, and a
# wrong index or a missed term is far larger.
BF16_REL_TOL = 1e-2
# f32 sums of 26 values in another order: a few f32 ulps
F32_REL_TOL = 1e-5
# the MLP's bias grad: the same bf16 values summed in f32 in another order,
# against the column's sum of |g_z|
MLP_BIAS_TOL = 1e-5
# DCN cross stack, kernel vs plain in bf16, per element as a share of
# dcn_cross_stack_scale: a t that rounds one bf16 step (2^-8 of itself)
# apart moves x0 * t by that, and the next layer's t by that times x0 . w
# (about N(0, 1)); eight steps leave room for |x0 . w| up to about 6 and a
# flip in each elementwise rounding (the kernel-order check below is exact)
DCN_BF16_REL_TOL = 2.0 ** -5
# f32 CIN layer, kernel vs plain: the same f32 sums (Hk * m terms) in another
# order; TF32 is off on both sides
F32_LAYER_REL_TOL = 1e-4
# torch.profiler windows to try before a kernel's profiled time is reported
# as not measured (a window once recorded no kernel of the card)
PROFILER_TRIES = 3


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


def launch_split(fn, calls: int = 20) -> dict[str, float]:
    """Device time per call of each kernel ``fn`` launches, by name (cut to
    the function's own), from torch.profiler over back-to-back calls (with
    the L2 as the previous call left it; a kernel launched twice a call
    counts both). Empty if in PROFILER_TRIES windows the profiler recorded
    no kernel of the card."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILER_TRIES):
        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        split = {}
        for e in prof.key_averages():
            if str(e.device_type).endswith("CUDA"):
                dev_us = getattr(e, "self_device_time_total", None)
                dev_us = e.self_cuda_time_total if dev_us is None else dev_us
                name = e.key.replace("(anonymous namespace)::", "").replace("void ", "").split("(")[0]
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


def bound_ms(nbytes: float, flops: float = 0.0, flops_kind: str = "bf16_flops_per_s") -> tuple[float, str]:
    """``benchmark.counts.bound_ms`` on this card (its peaks from
    benchmark/peaks.json) and what sets it: "bytes" over the memory rate or
    "operations" over the ``flops_kind`` rate."""
    card = torch.cuda.get_device_name(0)
    ms = counts.bound_ms(card, flops=flops, nbytes=nbytes, flops_kind=flops_kind)
    check(ms is not None, f"benchmark/peaks.json lists the card {card!r}")
    by_bytes = nbytes / counts.peak(card, "hbm_bytes_per_s") >= flops / counts.peak(card, flops_kind)
    return ms, "bytes" if by_bytes else "operations"


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
    return bound_ms(sectors * 32)[0]


def rel_err(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """(max |got - want|, max |want|) in f32."""
    got, want = got.float(), want.float()
    return (got - want).abs().max().item(), want.abs().max().item()


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
    rows' draws do not move). Each time beside its plain version's at
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
                              2 * r * hk * m * hn, "f32_flops_per_s" if f32 else "bf16_flops_per_s")
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
        b_ms, b_by = bound_ms(emb.numel() * esize + b * esize, 3 * emb.numel(), "f32_flops_per_s")
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
                              5 * N_CROSS * x0.numel(), "f32_flops_per_s")
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
    from recmodels_tpu_torch.data import SyntheticSource
    from recmodels_tpu_torch.embedding.gather import gather_rows, gather_rows_reference
    from recmodels_tpu_torch.embedding.optim import slot_sorted_ids
    from recmodels_tpu_torch.embedding.update import (
        sorted_adagrad_update, sorted_adagrad_update_reference,
    )
    from recmodels_tpu_torch.models import build_model
    from recmodels_tpu_torch.ops.cuda import build
    from recmodels_tpu_torch.ops.cuda.interactions_cuda import (
        cin2_backward, cin2_backward_reference, cin2_forward, cin2_forward_reference, split_fused_rows,
        split_fused_rows_backward, split_fused_rows_backward_reference, split_fused_rows_reference,
    )
    from recmodels_tpu_torch.train.engine import Engine
    from recmodels_tpu_torch.utils.config import TrainConfig, build_schema

    dev = torch.device("cuda")
    t_run = time.perf_counter()
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
    print(f"== kernels (flagship shapes; the slice-3 paths' after the first six, then slice 4's) at "
          f"{time.perf_counter() - t_run:.1f} s")
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
    # rows see the generator where they always have); its library call is
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
    print(f"== the sharded owner's #1 and #4 at {time.perf_counter() - t_run:.1f} s")
    owner_rows(report, engine, schema)
    print(f"== the batch kernel at {time.perf_counter() - t_run:.1f} s")
    report["synth_batch"] = synth_row(schema)
    print(f"== the DLRM-DCNv2 cell's bag gather and #4 at {time.perf_counter() - t_run:.1f} s")
    bag_rows(report)
    print(f"== the MLP epilogues at {time.perf_counter() - t_run:.1f} s")
    mlp_rows(report)
    print(f"== the Wukong FM kernels at {time.perf_counter() - t_run:.1f} s")
    wukong_rows(report)
    wukong_ln_rows(report)
    print(f"== launches a step at {time.perf_counter() - t_run:.1f} s")
    paths, served = launches_per_step(schema)
    print(f"== kernel rows at {time.perf_counter() - t_run:.1f} s")
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

    # each kernel's launches a step come from the first path in this order
    # that runs it (the flagship's for the six kernels of its step, slice 3's
    # for lazy Adam, the CIN layer and the transpose, DeepFM's for
    # fm_pairwise_forward, DCN's for dcn_cross_stack_forward); every path's
    # count is listed beside them (launches_per_step_lr: LR's, whose
    # sorted_adagrad_update count is #8's, the dim-1 instance)
    main_keys = ("route", "source", "replaces", "max_abs_err", "ms", "plain_ms", "bound_ms",
                 "bound_by", "library_ms")
    kernel_rows = []
    for name, r in report.items():
        path = next((p for p in paths if paths[p].get(name, 0) > 0), None)
        check(path is not None, f"{name} launched on a training path")
        kernel_rows.append(
            {"name": name, **{k: r[k] for k in main_keys[:3]}, "launches_per_step": paths[path][name],
             **{k: r[k] for k in main_keys[3:]}, "launches_from": path,
             **{f"launches_per_step_{p}": c.get(name, 0) for p, c in paths.items()},
             **{f"launches_served_{p}": c.get(name, 0) for p, c in served.items()},
             **{k: v for k, v in r.items() if k not in main_keys and k != "tol"}})
    print(json.dumps({"kernels": kernel_rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


def owner_rows(report: dict, engine, schema) -> None:
    """The sharded owner's #1 and #4 at world 1 (the ``owner_`` keys of
    their rows): a capacity factor of SHARDED_CAPACITY gives a bucket of
    532,480 positions for the batch's 425,984 ids, which hold the ids
    sorted and then sentinels (``ShardedTables._plan_group`` at d = 1). The
    gather reads the sentinels clamped to the last row; #4 skips them with
    their grads. The ids are the last batch of the 30-step stream
    OWNER_STREAM_SEED; the table and accumulator are drawn, at the
    flagship's 2,600,960 x 17."""
    from recmodels_tpu_torch.data import SyntheticSource
    from recmodels_tpu_torch.embedding.gather import gather_rows, gather_rows_reference
    from recmodels_tpu_torch.embedding.optim import slot_sorted_ids
    from recmodels_tpu_torch.embedding.update import sorted_adagrad_update, sorted_adagrad_update_reference

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    src = iter(SyntheticSource(schema, batch_size=BATCH, seed=OWNER_STREAM_SEED))
    for _ in range(OWNER_BATCH_INDEX):
        next(src)
    ids = torch.as_tensor(next(src).ids, device=dev)
    (grp,) = engine.collections["emb"].groups
    rows = grp.alloc_rows
    sorted_ids, _, _ = slot_sorted_ids(engine.collections["emb"].group_row_ids(ids)[grp.name])
    n = sorted_ids.numel()
    cap = max(8, -(-int(n * SHARDED_CAPACITY) // 8) * 8)
    owner_stream = torch.cat([sorted_ids, torch.full((cap - n,), rows, dtype=torch.int32, device=dev)])
    owner_ids = owner_stream.clamp_max(rows - 1)
    table = torch.randn((rows, DIM + 1), generator=gen, device=dev) * 0.05
    acc = torch.full_like(table, 0.1) + torch.rand(table.shape, generator=gen, device=dev)

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
    report["gather_rows"]["shapes"] += (f"; owner_: the sharded owner's gather at world 1, cap = {cap} ids "
                                        f"(the batch's {n} sorted, then sentinels clamped to the last row)")
    del ref
    grads = (torch.randn((cap, DIM + 1), generator=gen, device=dev) * 0.01).to(torch.bfloat16)
    lr_t, eps = torch.tensor(1e-2, device=dev), 1e-8
    t_cpu, a_cpu = table.cpu(), acc.cpu()
    sorted_adagrad_update_reference(t_cpu, a_cpu, owner_stream.cpu(), grads.cpu(), lr_t.cpu(), eps)
    sorted_adagrad_update(table, acc, owner_stream, grads, lr_t, eps)
    err = max((table.cpu() - t_cpu).abs().max().item(), (acc.cpu() - a_cpu).abs().max().item())
    check(err == 0.0, f"owner's sparse update at cap ids with its sentinel tail bit for bit the CPU's ({err})")
    del t_cpu, a_cpu
    # the kernel reads the grads of real ids only: the sentinel tail's are
    # skipped with their ids
    touched = torch.unique(sorted_ids).numel()
    upd = {"owner_max_abs_err": err}
    upd["owner_bound_ms"], upd["owner_bound_by"] = bound_ms(cap * 4 + n * (DIM + 1) * 2 + touched * (DIM + 1) * 16)
    upd.update(short_times(lambda: sorted_adagrad_update(table, acc, owner_stream, grads, lr_t, eps),
                           lambda: sorted_adagrad_update_reference(table, acc, owner_stream, grads, lr_t, eps),
                           adagrad_library_step(table, owner_stream, grads, 1e-2, eps), "owner_"))
    report["sorted_adagrad_update"].update(upd)
    report["sorted_adagrad_update"]["shapes"] += (f"; owner_: the sharded owner's stream at world 1, cap = {cap} "
                                                  f"positions, the last {cap - n} sentinels")
    del table, acc, grads


def synth_row(schema) -> dict:
    """The batch kernel of in-graph data generation (``csrc/device_synth.cu``)
    against its plain version at B = BATCH of the flagship's schema, at each
    of SYNTH_STEPS: the raw draws and ids bit for bit, dense within one ulp,
    a label apart only where its uniform lies within SYNTH_LABEL_MARGIN of
    its probability; timed cold and warm (and launch by launch) beside its
    plain version and its bound."""
    from recmodels_tpu_torch.data import device_synth as ds

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
    bound, bound_by, counted = synth_bound(BATCH, schema.n_dense, schema.n_slots, proj.shape[1])
    return {"route": "cuda", "source": "recmodels_tpu_torch/csrc/device_synth.cu",
            "replaces": "none: recmodels_tpu/data/device_synth.py:69 batch_fn (jax.random, no pl.pallas_call)",
            "max_abs_err": max_err, **times, "bound_ms": bound, "bound_by": bound_by, "library_ms": None,
            "warm_by_launch": launch_split(lambda: fn(st)), "dense_ulps": worst_ulps, "label_flips": flips,
            **counted, "timing": SHORT_TIMING}


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
    t_bytes = bound_ms(nbytes)[0]
    t_ops = ops / PEAK_INT32_OP_PER_S * 1e3
    bound = (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
    return bound[0], bound[1], {"bytes": nbytes, "int_ops": ops, "bytes_ms": t_bytes, "int_ops_ms": t_ops}


def bag_rows(report: dict, seed: int = 1) -> None:
    """The pooled bag gather (``csrc/bag_gather.cu``'s ``bag_gather_kernel``,
    the row ``bag_gather``) and #4 at d = 128 (the ``d128_`` keys of
    ``sorted_adagrad_update``) on one batch of the benchmark's DLRM-DCNv2
    cell (``benchmark/configs/dlrm-dcnv2-criteo1tb.json``: 16,384 examples,
    214 ids in 26 bags, a 51,883,621 x 128 f32 table; ids from the cell's
    generator): each against its plain version (bits), timed by CUDA events
    over back-to-back calls and by torch.profiler; the gather beside the
    library's ``torch.nn.functional.embedding_bag(mode="sum")`` with its
    cast to bf16, and its byte bound (distinct rows, ids, the pooled bf16
    output). #4 both ways: on the expanded stream (the pooled grads'
    ``index_select`` along the sorted bags, then #4) and on the pooled grads
    read through the bags (``grad_index``, the cell's route), the two from
    one state bit for bit, beside #4's byte bound."""
    import torch.nn.functional as F

    from benchmark import counts_dcnv2
    from benchmark.gen import multihot, zipf
    from recmodels_tpu_torch.embedding.bag import bag_gather, bag_gather_reference
    from recmodels_tpu_torch.embedding.optim import bag_sorted_ids
    from recmodels_tpu_torch.embedding.update import sorted_adagrad_update, sorted_adagrad_update_reference

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
    b_ms, b_by = bound_ms(counts_dcnv2.bag_gather_bytes(unique, gids.numel(), b * len(hot), d))
    report["bag_gather"] = dict(
        route="cuda", source="recmodels_tpu_torch/csrc/bag_gather.cu",
        replaces="none: the JAX package has one id a slot (multi-hot pooled bags are the port's own)",
        max_abs_err=0.0, tol=0.0,
        shapes=f"B = {b}, {gids.numel()} ids in {len(hot)} bags, {unique} distinct rows, table {n_rows} x {d} "
               f"f32, bf16 out",
        ms=time_ms(lambda: bag_gather(table, gids, hot, torch.bfloat16)),
        warm_ms=device_ms(lambda: bag_gather(table, gids, hot, torch.bfloat16)),
        plain_ms=time_ms(lambda: bag_gather_reference(table, gids, hot, torch.bfloat16), iters=5),
        library_ms=time_ms(library), library_warm_ms=device_ms(library), library_rel_err=err,
        bound_ms=b_ms, bound_by=b_by,
        timing="ms, plain_ms, library_ms: CUDA events over back-to-back calls; warm_ms, library_warm_ms: the "
               "same calls by torch.profiler",
    )
    del got, lib
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
    b_ms, b_by = bound_ms(counts.adagrad_update_bytes(unique, sorted_ids.numel(), d))
    report["sorted_adagrad_update"].update(
        d128_max_abs_err=0.0, d128_ms=time_ms(update), d128_warm_ms=device_ms(update),
        d128_pooled_ms=time_ms(pooled_update), d128_pooled_warm_ms=device_ms(pooled_update),
        d128_expand_ms=time_ms(expand), d128_expand_warm_ms=device_ms(expand),
        d128_expand_update_ms=time_ms(expand_update), d128_expand_update_warm_ms=device_ms(expand_update),
        d128_plain_ms=time_ms(lambda: sorted_adagrad_update_reference(table, acc, sorted_ids, grads, lr, 1e-8),
                              iters=3),
        d128_library_ms=None, d128_bound_ms=b_ms, d128_bound_by=b_by,
        d128_timing="d128_: CUDA events over back-to-back calls, d128_*warm_ms the same calls by "
                    "torch.profiler; d128_ms the expanded stream's #4, d128_pooled_ms #4 on the pooled grads "
                    "(the cell's route), d128_expand_ms the expansion alone, d128_expand_update_ms both",
    )
    report["sorted_adagrad_update"]["shapes"] += (
        f"; d128_: the DLRM-DCNv2 cell's batch, {sorted_ids.numel()} sorted ids into {n_rows} x {d}, bf16 "
        f"grads ({unique} distinct rows)")
    del table, acc, grads, pooled
    torch.cuda.empty_cache()


def mlp_rows(report: dict) -> None:
    """The bf16 MLP's epilogues (``csrc/mlp_epilogue.cu``) at DLRM-DCNv2's
    widest layer, B = 16,384 by N = 1,024 with a ReLU: the forward
    (``bias_act``: bias, ReLU and the bf16 rounding of cuBLAS's f32
    product) and the backward with its bias sum (``act_backward``, two
    kernels, on the layer above's f32 input grad), each against its plain
    version (h and g_z bit for bit, g_b within MLP_BIAS_TOL of the column's
    |g_z| sum) and timed with ``short_times``; the library is PyTorch's chain
    they replace: z + b, relu and the cast forward; back the input grad's
    cast to bf16, autograd's cast back to f32, threshold_backward against
    the f32 ReLU output, the batch sum and the cast of g_z to bf16. Bounds
    by bytes: each input read and each output written once."""
    from recmodels_tpu_torch.nn.mlp_epilogue import act_backward, act_backward_reference, bias_act, bias_act_reference

    dev = torch.device("cuda")
    b, n = BATCH, 1024
    gen = torch.Generator(dev).manual_seed(SEED)
    z = torch.randn((b, n), generator=gen, device=dev)
    bias = torch.randn((n,), generator=gen, device=dev)
    cot = torch.randn((b, n), generator=gen, device=dev)
    h = bias_act(z, bias, True)
    check(torch.equal(h, bias_act_reference(z, bias, True)), "bias_act bit for bit its plain version")
    relu_out = torch.relu(z + bias)
    gz, gb = act_backward(cot, h)
    want_z, want_b = act_backward_reference(cot, h)
    check(torch.equal(gz, want_z), "act_backward's g_z bit for bit its plain version")
    b_err = float(((gb - want_b).abs() / want_z.float().abs().sum(dim=0)).max())
    check(b_err <= MLP_BIAS_TOL, f"act_backward's g_b within {MLP_BIAS_TOL} of |g_z| a column ({b_err:.3g})")

    def library_backward():
        g32 = cot.to(torch.bfloat16).float()
        masked = torch.ops.aten.threshold_backward(g32, relu_out, 0)
        return masked.to(torch.bfloat16), masked.sum(dim=0)

    shapes = f"z, g [{b}, {n}] f32, b [{n}] f32, h and g_z bf16, ReLU (DLRM-DCNv2's top MLP, layer 1)"
    fwd_ms, fwd_by = bound_ms(b * n * (4 + 2) + n * 4)
    report["bias_act"] = dict(
        route="cuda", source="recmodels_tpu_torch/csrc/mlp_epilogue.cu",
        replaces="none: XLA fuses the JAX package's bias, ReLU and convert into its product",
        max_abs_err=0.0, tol=0.0, shapes=shapes,
        **short_times(lambda: bias_act(z, bias, True), lambda: bias_act_reference(z, bias, True),
                      lambda: torch.relu(z + bias).to(torch.bfloat16)),
        bound_ms=fwd_ms, bound_by=fwd_by, timing=SHORT_TIMING,
    )
    bwd_ms, bwd_by = bound_ms(b * n * (4 + 2 + 2) + n * 4)
    report["act_backward"] = dict(
        route="cuda", source="recmodels_tpu_torch/csrc/mlp_epilogue.cu",
        replaces="none: XLA fuses the JAX package's bias, ReLU and convert into its product",
        max_abs_err=0.0, tol=0.0, bias_grad_rel_err=b_err, shapes=shapes,
        **short_times(lambda: act_backward(cot, h), lambda: act_backward_reference(cot, h), library_backward),
        bound_ms=bwd_ms, bound_by=bwd_by, timing=SHORT_TIMING,
    )
    del z, cot, h, relu_out, gz, want_z
    torch.cuda.empty_cache()


def wukong_rows(report: dict) -> None:
    """The Wukong FM kernels (``csrc/wukong_fm.cu``) at the Wukong cell's
    layer, B = 16,384, n = 32 embeddings of d = 128, FM rank k = 32, n_L =
    16 (the ``layer1_`` keys: layer 1's n = 27), each against its plain
    version (``nn/wukong_fm``: a, l and g_x within 1e-2 of their largest
    value, the weight grads within 1e-2 of the plain version's norm: Z and
    g_F round to bf16 after sums in another order) and timed with
    ``short_times``; no one PyTorch call computes either. Bounds by bytes
    (``benchmark.counts_wukong.fm_bytes``' terms): forward X read, a, l and
    the LN's statistics written; backward X, g_a, g_L and g_res read, g_x
    written."""
    from recmodels_tpu_torch.nn.wukong_fm import (
        fm_backward, fm_backward_reference, fm_forward, fm_forward_reference,
    )

    dev = torch.device("cuda")
    b, d, k, n_l, n_f = BATCH, 128, 32, 16, 16
    rows = {"fm_forward": {}, "fm_backward": {}}
    for n, prefix in ((32, ""), (27, "layer1_")):
        gen = torch.Generator(dev).manual_seed(SEED + n)
        x = torch.randn((b, n, d), generator=gen, device=dev).to(torch.bfloat16)
        y = (torch.randn((n, k), generator=gen, device=dev) / n ** 0.5).to(torch.bfloat16)
        w = (torch.randn((n, n_l), generator=gen, device=dev) / n ** 0.5).to(torch.bfloat16)
        scale = 1 + 0.1 * torch.randn((n * k,), generator=gen, device=dev)
        shift = 0.1 * torch.randn((n * k,), generator=gen, device=dev)
        g_a = torch.randn((b, n * k), generator=gen, device=dev).to(torch.bfloat16)
        g_s = torch.randn((b, n_f + n_l, d), generator=gen, device=dev).to(torch.bfloat16)
        g_res = torch.randn((b, n, d), generator=gen, device=dev).to(torch.bfloat16)
        a, l, mean, rstd = fm_forward(x, y, w, scale, shift)
        want = fm_forward_reference(x, y, w, scale, shift, 1e-5)
        fwd_err = max(rel_err(a, want[0])[0] / rel_err(a, want[0])[1], rel_err(l, want[1])[0] / rel_err(l, want[1])[1])
        check(fwd_err <= 1e-2, f"fm_forward within 1e-2 of its plain version (n {n}: {fwd_err:.3g})")
        grads = fm_backward(x, y, w, scale, mean, rstd, g_a, g_s, n_f, g_res)
        refs = fm_backward_reference(x, y, w, scale, mean, rstd, g_a, g_s, n_f, g_res)
        gx_err = rel_err(grads[0], refs[0])[0] / rel_err(grads[0], refs[0])[1]
        w_err = max(float((p - q).norm() / q.norm()) for p, q in zip(grads[1:], refs[1:]))
        check(gx_err <= 1e-2 and w_err <= 1e-2, f"fm_backward within 1e-2 of its plain version (n {n}: g_x "
              f"{gx_err:.3g}, weight grads {w_err:.3g})")
        again = fm_backward(x, y, w, scale, mean, rstd, g_a, g_s, n_f, g_res)
        check(all(torch.equal(p, q) for p, q in zip(grads, again)), "fm_backward repeats bit for bit")
        shapes = f"x [{b}, {n}, {d}] bf16, y [{n}, {k}], w [{n}, {n_l}], g_s [{b}, {n_f + n_l}, {d}]"
        fwd_ms, fwd_by = bound_ms(b * ((n * d + n * k + n_l * d) * 2 + 8))
        rows["fm_forward"].update({
            prefix + "max_abs_err": fwd_err, prefix + "tol": 1e-2, prefix + "shapes": shapes,
            **short_times(lambda: fm_forward(x, y, w, scale, shift),
                          lambda: fm_forward_reference(x, y, w, scale, shift, 1e-5), prefix=prefix),
            prefix + "library_ms": None, prefix + "bound_ms": fwd_ms, prefix + "bound_by": fwd_by})
        bwd_ms, bwd_by = bound_ms(b * ((3 * n * d + n * k + n_l * d) * 2 + 8))
        rows["fm_backward"].update({
            prefix + "max_abs_err": gx_err, prefix + "tol": 1e-2, prefix + "weight_grad_rel_err": w_err,
            prefix + "shapes": shapes,
            **short_times(lambda: fm_backward(x, y, w, scale, mean, rstd, g_a, g_s, n_f, g_res),
                          lambda: fm_backward_reference(x, y, w, scale, mean, rstd, g_a, g_s, n_f, g_res),
                          prefix=prefix),
            prefix + "library_ms": None, prefix + "bound_ms": bwd_ms, prefix + "bound_by": bwd_by})
        del x, y, w, g_a, g_s, g_res, a, l, grads, refs, again, want
    for name, r in rows.items():
        report[name] = dict(route="cuda", source="recmodels_tpu_torch/csrc/wukong_fm.cu",
                            replaces="none: the JAX package has no Wukong", timing=SHORT_TIMING, **r)
    torch.cuda.empty_cache()


def wukong_ln_rows(report: dict) -> None:
    """The Wukong residual sum and LayerNorm (``csrc/wukong_ln.cu``) at the
    Wukong cell's layer: B = 16,384 examples of 16 FMB and 16 LCB rows of
    d = 128, against its plain version (``nn/wukong_ln``: s bit for bit, y
    and g_s within 1e-2 of their largest value, the weight grads within 1e-4
    of the plain version's norm) and timed with ``short_times``; the library
    is what the kernels replace, ``torch.cat``, the add and PyTorch's fused
    ``layer_norm`` (the scale and shift in bf16), and its backward. Bounds by
    bytes: forward h, l, r read, s and y written (bf16), the row statistics
    (f32); backward g, s read, g_s and g_h written."""
    from recmodels_tpu_torch.nn.wukong_ln import (
        residual_ln_backward, residual_ln_backward_reference, residual_ln_forward, residual_ln_forward_reference,
    )

    dev = torch.device("cuda")
    b, n_f, n_l, d = BATCH, 16, 16, 128
    m = n_f + n_l
    gen = torch.Generator(dev).manual_seed(SEED)
    h = torch.randn((b, n_f * d), generator=gen, device=dev).to(torch.bfloat16)
    l = torch.randn((b, n_l, d), generator=gen, device=dev).to(torch.bfloat16)
    r = torch.randn((b, m, d), generator=gen, device=dev).to(torch.bfloat16)
    scale = 1 + 0.1 * torch.randn((d,), generator=gen, device=dev)
    shift = 0.1 * torch.randn((d,), generator=gen, device=dev)
    cot = torch.randn((b, m, d), generator=gen, device=dev).to(torch.bfloat16)
    s, y, mean, rstd = residual_ln_forward(h, l, r, scale, shift)
    want = residual_ln_forward_reference(h, l, r, scale, shift, 1e-5)
    y_err = rel_err(y, want[1])[0] / rel_err(y, want[1])[1]
    check(torch.equal(s, want[0]) and y_err <= 1e-2, f"residual_ln_forward within 1e-2 of its plain version ({y_err:.3g})")
    grads = residual_ln_backward(cot, s, mean, rstd, scale, n_f)
    refs = residual_ln_backward_reference(cot, s, mean, rstd, scale, n_f)
    g_err = rel_err(grads[0], refs[0])[0] / rel_err(grads[0], refs[0])[1]
    w_err = max(float((p - q).norm() / q.norm()) for p, q in zip(grads[2:], refs[2:]))
    check(g_err <= 1e-2 and w_err <= 1e-4, f"residual_ln_backward within its tolerances ({g_err:.3g}, {w_err:.3g})")
    sc16, sh16 = scale.to(torch.bfloat16), shift.to(torch.bfloat16)

    def library_forward():
        x = torch.cat([h.reshape(b, n_f, d), l], dim=1) + r
        return torch.native_layer_norm(x, (d,), sc16, sh16, 1e-5)

    lib_out = library_forward()

    def library_backward():
        return torch.ops.aten.native_layer_norm_backward(cot, lib_out[0], (d,), lib_out[1], lib_out[2], sc16, sh16,
                                                         [True, True, True])

    shapes = f"h [{b}, {n_f * d}], l [{b}, {n_l}, {d}], r, s, y, g [{b}, {m}, {d}] bf16, scale, shift [{d}] f32"
    fwd_ms, fwd_by = bound_ms(b * m * d * 2 * 4 + b * m * 8)
    report["residual_ln_forward"] = dict(
        route="cuda", source="recmodels_tpu_torch/csrc/wukong_ln.cu",
        replaces="none: the JAX package has no Wukong", max_abs_err=y_err, tol=1e-2, shapes=shapes,
        **short_times(lambda: residual_ln_forward(h, l, r, scale, shift),
                      lambda: residual_ln_forward_reference(h, l, r, scale, shift, 1e-5), library_forward),
        bound_ms=fwd_ms, bound_by=fwd_by, timing=SHORT_TIMING)
    bwd_ms, bwd_by = bound_ms(b * m * d * 2 * 3 + b * n_f * d * 2 + b * m * 8)
    report["residual_ln_backward"] = dict(
        route="cuda", source="recmodels_tpu_torch/csrc/wukong_ln.cu",
        replaces="none: the JAX package has no Wukong", max_abs_err=g_err, tol=1e-2, weight_grad_rel_err=w_err,
        shapes=shapes,
        **short_times(lambda: residual_ln_backward(cot, s, mean, rstd, scale, n_f),
                      lambda: residual_ln_backward_reference(cot, s, mean, rstd, scale, n_f), library_backward),
        bound_ms=bwd_ms, bound_by=bwd_by, timing=SHORT_TIMING)
    del h, l, r, cot, s, y, grads, refs, want, lib_out
    torch.cuda.empty_cache()


def launches_per_step(schema) -> tuple[dict[str, dict[str, int]], dict[str, dict[str, int]]]:
    """Each kernel's launches (the wrappers' ``.launches``, set to 0 just
    before and read just after) in one eager training step of each path,
    and in one eager served forward (``Engine.logits``) of each path but
    the generated and the sharded ones: the flagship (``slice2``), slice 3
    (CIN(128,128,128), an unfused wide table, lazy Adam on both tables),
    DeepFM, DCN, FM, f32 xDeepFM (bench.py --no-bf16: its CIN a layer at a
    time), LR, PNN, Wide&Deep, NFM and AFM at bench.py's widths and 26 slots
    of VOCAB ids; one generated step of the flagship (``train_scan_gen``);
    DLRM-DCNv2 and Wukong at their cells' widths and batch with their
    vocabularies cut to 10,000 a slot (the counts depend on the widths, not
    the rows); then, in
    an NCCL world of one, the sharded flagship and slice 3, and the sharded
    flagship restored from a checkpoint of the local one. Each path's counts
    are keyed by kernel name, in the order the kernel rows take their count
    from. Every path with a served forward also serves a request of
    SERVE_REQUEST through the Predictor's bucket graph and replays a
    captured step (``replayed``), and the flagship trains CLI_STEPS steps
    through ``cli.train`` under a watchdog; these are checked, not
    counted."""
    import socket
    import tempfile

    import torch.distributed as dist

    from benchmark import port_multihot, port_wukong
    from recmodels_tpu_torch.cli import train as train_cli
    from recmodels_tpu_torch.data import SyntheticSource
    from recmodels_tpu_torch.data import device_synth as ds
    from recmodels_tpu_torch.embedding.bag import bag_gather
    from recmodels_tpu_torch.embedding.gather import gather_rows
    from recmodels_tpu_torch.embedding.update import sorted_adagrad_update, sorted_adam_update
    from recmodels_tpu_torch.models import build_model
    from recmodels_tpu_torch.nn.mlp_epilogue import act_backward, bias_act
    from recmodels_tpu_torch.nn.wukong_fm import fm_backward, fm_forward
    from recmodels_tpu_torch.nn.wukong_ln import residual_ln_backward, residual_ln_forward
    from recmodels_tpu_torch.ops.cuda import interactions_cuda as K
    from recmodels_tpu_torch.parallel import build_parallel_engine, make_mesh, multihost, shard_state
    from recmodels_tpu_torch.train.checkpoint import CheckpointManager
    from recmodels_tpu_torch.train.engine import Engine
    from recmodels_tpu_torch.utils.config import TrainConfig

    kernels = (gather_rows, K.split_fused_rows, K.cin2_forward, sorted_adagrad_update, K.split_fused_rows_backward,
               K.cin2_backward, sorted_adam_update, K.cin_layer_forward, K.cin_layer_backward, K.transpose_minor2,
               K.fm_pairwise_forward, K.dcn_cross_stack_forward, ds.synth_batch, bag_gather, bias_act,
               act_backward, fm_forward, fm_backward, residual_ln_forward, residual_ln_backward)
    dev = torch.device("cuda")

    def counted(step) -> dict[str, int]:
        torch.cuda.synchronize()
        for k in kernels:
            k.launches = 0
        step()
        torch.cuda.synchronize()
        return {k.__name__: k.launches for k in kernels if k.launches}

    def batch_of(n: int):
        b = next(iter(SyntheticSource(schema, batch_size=n, seed=SEED)))
        return [torch.as_tensor(a, device=dev) for a in (b.dense, b.ids, b.labels)]

    def served_and_replayed(path, engine, state, batch) -> None:
        with torch.inference_mode():
            served[path] = counted(lambda: engine.logits(state, batch[0], batch[1]))
        replayed(path, engine, state, batch)

    slice3 = dict(dense_lr=1e-3, emb_lr=1e-2, sparse_optimizer="adam", fuse_wide=False)
    # (path, model, bf16, the model's TrainConfig fields, the engine's options, batch)
    paths = (
        ("slice2", "xdeepfm", True, dict(cin_sizes=CIN, hidden=HIDDEN), {}, BATCH),
        ("slice3", "xdeepfm", True, dict(cin_sizes=CIN3, hidden=HIDDEN), slice3, BATCH),
        ("deepfm", "deepfm", True, dict(hidden=DEEPFM_HIDDEN), {}, BATCH),
        ("dcn", "dcn", True, dict(hidden=DCN_HIDDEN, n_cross=N_CROSS), {}, BATCH),
        ("fm", "fm", False, {}, {}, FM_BATCH),
        ("xdeepfm_f32", "xdeepfm", False, dict(cin_sizes=CIN, hidden=HIDDEN), {}, BATCH),
        ("lr", "lr", False, {}, {}, BATCH),
        ("pnn", "pnn", True, dict(pnn_mode="both", hidden=PNN_HIDDEN), {}, BATCH),
        ("widedeep", "widedeep", True, dict(hidden=WIDEDEEP_HIDDEN), {}, BATCH),
        ("nfm", "nfm", True, dict(hidden=NFM_HIDDEN), {}, BATCH),
        ("afm", "afm", True, dict(attention_dim=AFM_ATTENTION), {}, BATCH),
    )
    configs, out, served = {}, {}, {}
    for path, model, bf16, kw, opts, n in paths:
        cfg = TrainConfig(model=model, bf16=bf16, vocab_size=VOCAB, embed_dim=DIM, batch_size=n, seed=SEED, **kw)
        configs[path] = (cfg, opts)
        engine = Engine(build_model(model, schema, **cfg.model_kwargs()), **opts)
        state, batch = engine.init(seed=SEED, device=dev), batch_of(n)
        out[path] = counted(lambda: engine.train_step(state, *batch))
        served_and_replayed(path, engine, state, batch)
        if path == "slice2":  # the generated step of the same engine
            fn = ds.make_device_batch_fn(schema, BATCH, seed=SEED)
            gen_state = engine.init(seed=SEED, device=dev)
            generated = counted(lambda: engine.train_scan_gen(gen_state, 0, k=1, batch_fn=fn))
            del gen_state
        del engine, state, batch
    out["device_synth"] = generated

    for path, config, door in (("dlrm_dcnv2", "dlrm-dcnv2-criteo1tb", port_multihot),
                               ("wukong", "wukong-criteo1tb", port_wukong)):
        cfg = json.load(open(os.path.join(ROOT, "benchmark", "configs", f"{config}.json")))
        cfg["num_embeddings_per_feature"] = [min(v, 10_000) for v in cfg["num_embeddings_per_feature"]]
        engine = door.build_engine(cfg)
        sch = engine.model.schema
        g = torch.Generator(device=dev).manual_seed(SEED)
        b = cfg["batch_size"]
        vocab = torch.tensor(sch.id_vocab_sizes, device=dev)
        ids = (torch.rand((b, len(sch.id_vocab_sizes)), generator=g, device=dev) * vocab).int()
        dense = torch.rand((b, sch.n_dense), generator=g, device=dev)
        labels = (torch.rand(b, generator=g, device=dev) < 0.25).float()
        state = engine.init(seed=SEED, device=dev)
        out[path] = counted(lambda: engine.train_step(state, dense, ids, labels))
        served_and_replayed(path, engine, state, (dense, ids, labels))
        del engine, state, ids, dense, labels

    cfg, _ = configs["slice2"]
    argv = ["--model", cfg.model, "--batch-size", str(BATCH), "--steps", str(CLI_STEPS), "--data", "synthetic",
            *(a for k in ("bf16", "vocab_size", "embed_dim", "cin_sizes", "hidden", "seed")
              for a in ("--set", f"{k}={getattr(cfg, k)}")), "--set", "log_every=1"]
    print("$ python -m recmodels_tpu_torch.cli.train " + " ".join(argv))
    faulthandler.dump_traceback_later(CLI_LIMIT_S, exit=True)
    try:
        cli = counted(lambda: check(train_cli.main(argv) == 0, "cli.train returns 0"))
    finally:
        faulthandler.cancel_dump_traceback_later()
    check(all(cli.get(name, 0) > 0 for name in out["slice2"]), f"cli.train launches the flagship's kernels: {cli}")

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    multihost.initialize(f"127.0.0.1:{port}", 1, 0)
    try:
        mesh = make_mesh(1)
        check(dist.get_backend() == "nccl" and mesh.device.type == "cuda", "an NCCL world of one on the card")
        batch = batch_of(BATCH)
        for path, name in (("slice2", "sharded"), ("slice3", "sharded3")):
            cfg, opts = configs[path]
            sharded = build_parallel_engine(build_model(cfg.model, schema, **cfg.model_kwargs()), mesh,
                                            capacity_factor=SHARDED_CAPACITY, **opts)
            state = shard_state(sharded.init(seed=SEED, device=dev), mesh)
            out[name] = counted(lambda: sharded.train_step(state, *batch))
            del sharded, state
        # the local flagship checkpointed and restored into the sharded
        # flagship: logits bit for bit the local ones, then one counted step
        cfg, _ = configs["slice2"]
        engine = Engine(build_model(cfg.model, schema, **cfg.model_kwargs()))
        sharded = build_parallel_engine(build_model(cfg.model, schema, **cfg.model_kwargs()), mesh,
                                        capacity_factor=SHARDED_CAPACITY)
        local = engine.init(seed=SEED, device=dev)
        with tempfile.TemporaryDirectory() as ckpt:
            mgr = CheckpointManager(ckpt)
            mgr.save(1, local, {"step": 1})
            mgr.wait()
            target = shard_state(sharded.init(seed=SEED + 1, device=dev), mesh)
            state, data = CheckpointManager(ckpt, mesh=mesh).restore_cross_geometry(target)
        with torch.no_grad():
            check(data == {"step": 1} and torch.equal(sharded.logits(state, batch[0], batch[1]),
                                                      engine.logits(local, batch[0], batch[1])),
                  "the restored sharded state's logits equal the local state's bit for bit")
        out["sharded_restored"] = counted(lambda: sharded.train_step(state, *batch))
        check(out["sharded_restored"] == out["sharded"], "the restored sharded step launches the sharded one's kernels")
        del engine, local, sharded, state, target
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    for path, c in out.items():
        print(f"launches in one eager step of {path}: {c}")
    for path, c in served.items():
        print(f"launches in one eager served forward of {path}: {c}")
    return out, served


def replayed(path: str, engine, state, batch) -> None:
    """One request of SERVE_REQUEST examples (a bucket of its own, so no
    padding) through the Predictor's bucket graph, bit for bit eager
    ``Engine.logits`` on it; then two calls of ``jit_train_step`` (the eager
    first call, then the capture and its replay): one graph, a finite
    loss."""
    import numpy as np

    from recmodels_tpu_torch.serve import Predictor

    dense, ids = batch[0][:SERVE_REQUEST], batch[1][:SERVE_REQUEST]
    pred = Predictor(engine, state, dense.device)
    got = pred.predict_logits(dense.cpu().numpy(), ids.cpu().numpy())
    with torch.inference_mode():
        want = engine.logits(state, dense, ids).cpu().numpy()
    check(sorted(pred._buckets) == [SERVE_REQUEST] and pred._buckets[SERVE_REQUEST].graph is not None
          and np.array_equal(got, want), f"{path}: the Predictor's bucket graph gives eager Engine.logits")
    del pred
    ts = engine.jit_train_step()
    for _ in range(2):
        state, m = ts(state, *batch)
    check(ts.graphs == 1 and bool(torch.isfinite(m["loss"])), f"{path}: a captured step replays, its loss finite")
    del ts, m


if __name__ == "__main__":
    sys.exit(main())
