#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving and training paths on one NVIDIA GPU
and check them.

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
               table of as many rows); its time, the plain version's, a single
               PyTorch call's where one computes the same function, and its
               bound (the larger of bytes over the memory rate and operations
               over the peak rate, from the H100 SXM data sheet);
  4. serving:  full-width bf16 xDeepFM (26 x 1e5 ids, dim 16, CIN(128,128),
               DNN(400,400)) initialised from a seed (with weights under which
               each kernel's output moves the logits), exported, loaded with
               load_predictor(device="cuda") and asked requests of 1, 1,000 and
               16,384 examples; every serving kernel must have launched, the
               logits must be finite and match the same artifact served on the
               CPU by the plain path; throughput at 16,384;
  5. training: the same model trained with Engine.train_step at 16,384
               (dense Adam lr 1e-3, sparse Adagrad lr 1e-2) for 30 steps of the
               synthetic stream; every kernel of the step must have launched,
               the loss must be finite and fall; one step from live weights
               at 1,024 examples must match the CPU plain path's step (loss,
               Adam moments, which hold the dense grads, the touched rows of
               the table and acc, untouched rows bit for bit); the step's device time,
               examples/s and profile;
  6. a JSON line listing the kernels (launches from the training run), then
     the card line again, then the result line {"ok": true, "device": {...}}.

Any failed check raises, so the script exits non-zero before the result line.
It also exits non-zero when no CUDA device is present, and when it stands
alone, without the package beside it.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM data sheet, dense: device memory rate and bf16 tensor-core rate
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOP_PER_S = 989e12

BATCH = 16_384
VOCAB = 100_000
DIM = 16
CIN = (128, 128)
HIDDEN = (400, 400)
SEED = 0
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
TRAIN_STEPS = 30
TRAIN_CHECK_BATCH = 1024
# GPU step vs CPU step from one state: the grads pass through the same bf16
# rounding points; a rounding that lands one bf16 step apart in the CIN or
# the MLP moves a grad by about 2^-8 of its size. 3% of the largest change
# of each tensor, or part of the table (the repo's bf16 rule,
# tests/test_tpu_kernels.py), bounds it.
STEP_REL_TOL = 0.03


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


def profile(fn, calls: int = 3, top: int = 12) -> float:
    """Print the device time per call of the kernels ``fn`` runs, from
    torch.profiler, and the share of the window the device was busy; return
    the kernels' time per call (ms)."""
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
    print(f"profile: {sum(r[1] for r in rows)} kernel launches per call")
    return busy / calls


def bound_ms(nbytes: float, flops: float = 0.0) -> tuple[float, str]:
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_BF16_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def rel_err(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """(max |got - want|, max |want|) in f32."""
    got, want = got.float(), want.float()
    return (got - want).abs().max().item(), want.abs().max().item()


def liven(state, gen: torch.Generator) -> None:
    """Give every kernel of the serving path a visible share of the logits,
    in place. ``Engine.init`` leaves the fused wide column, ``w_dense`` and
    the bias at zero, and its N(0, 0.05) rows leave the second CIN pool near
    1e-3 of a logit: a wrong ``wide_sum`` or p2 would still pass the
    GPU-vs-CPU check. Rows N(0, 0.5), a wide column N(0, 0.2) and a drawn
    ``w_dense`` and bias fix that; ``term_sizes`` checks it."""
    for table in state.emb_params["emb"].values():
        table[:, :-1] *= 10.0
        table[:, -1] = torch.randn(table.shape[0], generator=gen, device=table.device) * 0.2
    dp = state.dense_params
    dev = dp["w_dense"].device
    dp["w_dense"] = torch.randn(dp["w_dense"].shape, generator=gen, device=dev) * 0.1
    dp["bias"] = torch.randn((), generator=gen, device=dev) * 0.1


def term_sizes(pred, ids) -> dict[str, float]:
    """Largest |contribution| to a logit of ``wide_sum``, p1 . w_cin and
    p2 . w_cin over the examples given, through the predictor's own wrappers
    (the plain versions for a CPU predictor)."""
    from recmodels_tpu_torch.embedding.gather import gather_rows
    from recmodels_tpu_torch.ops.cuda.interactions_cuda import cin2_forward, split_fused_rows

    eng, st = pred.engine, pred.state
    coll = eng.collections["emb"]
    (g,) = coll.groups
    with torch.inference_mode():
        gids = coll.group_row_ids(torch.as_tensor(ids, device=pred.device))[g.name]
        full = gather_rows(st.emb_params["emb"][g.name], gids, torch.bfloat16)
        x_dm, ws = split_fused_rows(full, g.dim - 1)
        w1, w2 = (w.to(torch.bfloat16) for w in st.dense_params["cin_w"])
        _, p1, p2, _ = cin2_forward(x_dm.reshape(-1, x_dm.shape[2]), w1, w2, g.dim - 1)
        w_cin = st.dense_params["w_cin"]
        h1 = p1.shape[1]
        return {"wide_sum": ws.abs().max().item(),
                "p1 . w_cin": (p1.float() @ w_cin[:h1]).abs().max().item(),
                "p2 . w_cin": (p2.float() @ w_cin[h1:]).abs().max().item()}


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


def adagrad_library_ms(table, ids, grads, lr, eps) -> float:
    """torch.optim.Adagrad's sparse step on the same update (its sparse path
    sums duplicates, adds g^2 to the accumulator and divides by sqrt + eps,
    from an accumulator of 0.1): the yardstick, used nowhere in the port."""
    keep = ids < table.shape[0]
    param = torch.nn.Parameter(table.clone())
    param.grad = torch.sparse_coo_tensor(ids[keep].long()[None], grads[keep].float(),
                                         size=table.shape, check_invariants=False)
    opt = torch.optim.Adagrad([param], lr=lr, eps=eps, initial_accumulator_value=0.1)
    return time_ms(opt.step, iters=10)


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
        cin2_backward, cin2_backward_reference, cin2_forward, cin2_forward_reference,
        split_fused_rows, split_fused_rows_backward, split_fused_rows_backward_reference,
        split_fused_rows_reference,
    )
    from recmodels_tpu_torch.serve import export_model, load_predictor
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
            if line.startswith("==") or "registers" in line or "spill" in line:
                print("  " + line.strip())

    cfg = TrainConfig(model="xdeepfm", bf16=True, vocab_size=VOCAB, embed_dim=DIM,
                      cin_sizes=CIN, hidden=HIDDEN, batch_size=BATCH, seed=SEED)
    schema = build_schema(cfg)
    engine = Engine(build_model(cfg.model, schema, **cfg.model_kwargs()))
    batch = next(iter(SyntheticSource(schema, batch_size=BATCH, seed=7)))
    ids = torch.as_tensor(batch.ids, device=dev)
    dense = torch.as_tensor(batch.dense, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rows = engine.collections["emb"].groups[0].alloc_rows
    m = schema.n_slots

    # -------------------------------------------------------------- kernels
    print("== kernels (flagship shapes)")
    report = {}

    # 1. gather: 26 x 1e5 ids (2,600,960 rows of 17 f32), batch-order ids
    table = torch.randn((rows, DIM + 1), generator=gen, device=dev) * 0.05
    gids = engine.collections["emb"].group_row_ids(ids)["d17"]
    got = gather_rows(table, gids, torch.bfloat16)
    want = gather_rows_reference(table, gids, torch.bfloat16)
    err = (got.float() - want.float()).abs().max().item()
    check(torch.equal(got, want), f"gather bf16 rows bit-exact (max err {err})")
    check(torch.equal(gather_rows(table, gids, torch.float32),
                      gather_rows_reference(table, gids, torch.float32)), "gather f32 rows bit-exact")
    n = gids.numel()
    touched = torch.unique(gids).numel()
    b_ms, b_by = bound_ms(touched * (DIM + 1) * 4 + n * 4 + n * (DIM + 1) * 2)
    report["gather_rows"] = dict(
        route="cuda", source="recmodels_tpu_torch/csrc/gather.cu",
        replaces="recmodels_tpu/embedding/pallas_gather.py:180", max_abs_err=err, tol=0.0,
        ms=time_ms(lambda: gather_rows(table, gids, torch.bfloat16)),
        plain_ms=time_ms(lambda: gather_rows_reference(table, gids, torch.bfloat16)),
        library_ms=time_ms(lambda: torch.index_select(table, 0, gids.reshape(-1)).to(torch.bfloat16)),
        bound_ms=b_ms, bound_by=b_by,
    )

    # 2. split_fused_rows on the gathered rows [16384, 26, 17] bf16
    full = got
    x_dm, ws = split_fused_rows(full, DIM)
    x_ref, ws_ref = split_fused_rows_reference(full, DIM)
    check(torch.equal(x_dm, x_ref), "split_fused_rows x_dm exact")
    err, scale = rel_err(ws, ws_ref)
    check(ws.shape == (BATCH,) and err <= F32_REL_TOL * max(scale, 1.0),
          f"split_fused_rows wide_sum {err} <= {F32_REL_TOL} * max(|ref|, 1)")
    b_ms, b_by = bound_ms(full.numel() * 2 + x_dm.numel() * 2 + ws.numel() * 4, BATCH * m)
    report["split_fused_rows"] = dict(
        route="cuda", source="recmodels_tpu_torch/csrc/split_fused.cu",
        replaces="recmodels_tpu/ops/pallas/interactions_tpu.py:881", max_abs_err=err,
        tol=F32_REL_TOL * max(scale, 1.0),
        ms=time_ms(lambda: split_fused_rows(full, DIM)),
        plain_ms=time_ms(lambda: split_fused_rows_reference(full, DIM)),
        library_ms=None, bound_ms=b_ms, bound_by=b_by,
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
    macs = BATCH * DIM * m * m * h1 + BATCH * DIM * m * h1 + BATCH * m * h1 * h2
    b_ms, b_by = bound_ms((x02.numel() + w1.numel() + w2.numel() + BATCH * (h1 + h2)) * 2, 2 * macs)
    report["cin2_forward"] = dict(
        route="cuda", source="recmodels_tpu_torch/csrc/cin2.cu",
        replaces="recmodels_tpu/ops/pallas/interactions_tpu.py:564",
        max_abs_err=max(e for e, _ in errs), tol=max(t for _, t in errs),
        ms=time_ms(lambda: cin2_forward(x02, w1, w2, DIM)),
        plain_ms=time_ms(lambda: cin2_forward_reference(x02, w1, w2, DIM), iters=5),
        library_ms=None, bound_ms=b_ms, bound_by=b_by,
    )

    # 4. split_fused_rows_backward: g_dm [16384, 16, 26] bf16, g_ws [16384] f32
    g_dm = torch.randn((BATCH, DIM, m), generator=gen, device=dev).to(torch.bfloat16)
    g_ws = torch.randn((BATCH,), generator=gen, device=dev)
    got = split_fused_rows_backward(g_dm, g_ws)
    check(torch.equal(got, split_fused_rows_backward_reference(g_dm, g_ws)),
          "split_fused_rows_backward exact")
    b_ms, b_by = bound_ms(g_dm.numel() * 2 + g_ws.numel() * 4 + got.numel() * 2, 0.0)
    report["split_fused_rows_backward"] = dict(
        route="cuda", source="recmodels_tpu_torch/csrc/split_fused.cu",
        replaces="recmodels_tpu/ops/pallas/interactions_tpu.py:939", max_abs_err=0.0, tol=0.0,
        ms=time_ms(lambda: split_fused_rows_backward(g_dm, g_ws)),
        plain_ms=time_ms(lambda: split_fused_rows_backward_reference(g_dm, g_ws)),
        library_ms=None, bound_ms=b_ms, bound_by=b_by,
    )
    del g_dm, g_ws, got

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
    macs = (2 * rows_ * m * m * h1 + 2 * BATCH * h2 * m * h1 + 2 * rows_ * m * h1
            + 2 * rows_ * m * m)
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
    )
    del bwd, x1, q, g1p, g2p, x02

    # 6. sorted_adagrad_update: the batch's sorted stream (425,984 ids) into
    # the 2,600,960 x 17 table, bf16 grads N(0, 0.01); then a dim-1 table
    sorted_ids, _, _ = slot_sorted_ids(gids)
    n = sorted_ids.numel()
    lr, eps = 1e-2, 1e-8
    update = {}
    for label, d1 in (("", DIM + 1), ("dim1_", 1)):
        shape = (rows, d1) if d1 > 1 else (rows,)
        upd_table = table.clone() if d1 > 1 else table[:, -1].contiguous()
        upd_acc = torch.full(shape, 0.1, device=dev) + torch.rand(shape, generator=gen, device=dev)
        grads = (torch.randn((n, *shape[1:]), generator=gen, device=dev) * 0.01).to(torch.bfloat16)
        t_cpu, a_cpu = upd_table.cpu(), upd_acc.cpu()
        sorted_adagrad_update_reference(t_cpu, a_cpu, sorted_ids.cpu(), grads.cpu(), lr, eps)
        sorted_adagrad_update(upd_table, upd_acc, sorted_ids, grads, lr, eps)
        torch.cuda.synchronize()
        err = max((upd_table.cpu() - t_cpu).abs().max().item(), (upd_acc.cpu() - a_cpu).abs().max().item())
        check(err == 0.0, f"sorted_adagrad_update {label or 'd17 '}bit-exact against the CPU plain version ({err})")
        touched = torch.unique(sorted_ids).numel()
        b_ms, b_by = bound_ms(n * 4 + grads.numel() * 2 + touched * d1 * 4 * 4, 0.0)
        update.update({
            f"{label}max_abs_err": err, f"{label}bound_ms": b_ms, f"{label}bound_by": b_by,
            f"{label}ms": time_ms(lambda: sorted_adagrad_update(upd_table, upd_acc, sorted_ids, grads, lr, eps)),
            f"{label}plain_ms": time_ms(lambda: sorted_adagrad_update_reference(
                upd_table, upd_acc, sorted_ids, grads, lr, eps), iters=5),
            f"{label}library_ms": adagrad_library_ms(upd_table, sorted_ids, grads, lr, eps),
        })
        del upd_table, upd_acc, grads, t_cpu, a_cpu
    report["sorted_adagrad_update"] = dict(
        route="cuda", source="recmodels_tpu_torch/csrc/adagrad_update.cu",
        replaces="recmodels_tpu/embedding/pallas_update.py:427",
        also_replaces="recmodels_tpu/embedding/pallas_update.py:296 (the dim1_ keys)",
        tol=0.0, **update,
    )
    print(f"sorted_adagrad_update dim-1 [{rows}]: max err {update['dim1_max_abs_err']:.6g}; kernel "
          f"{update['dim1_ms']:.4f} ms, plain {update['dim1_plain_ms']:.4f} ms, library "
          f"{update['dim1_library_ms']:.4f} ms, bound {update['dim1_bound_ms']:.4f} ms "
          f"({update['dim1_bound_by']}) on {card}")
    del table
    for name, r in report.items():
        print(f"{name}: max err {r['max_abs_err']:.6g} (tol {r['tol']:.6g}); "
              f"kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library "
              f"{'-' if r['library_ms'] is None else format(r['library_ms'], '.4f') + ' ms'}, "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}) on {card}")

    # -------------------------------------------------------------- serving
    print("== serving (full-width bf16 xDeepFM)")
    state = engine.init(seed=SEED, device=dev)
    liven(state, gen)
    kernels = (gather_rows, split_fused_rows, cin2_forward)
    with tempfile.TemporaryDirectory() as art:
        export_model(art, cfg, engine, state)
        del state
        pred = load_predictor(art, device="cuda")
        for k in kernels:
            k.launches = 0
        answers = {}
        for size in (1, 1000, BATCH):
            answers[size] = pred.predict_logits(batch.dense[:size], batch.ids[:size])
            check(answers[size].shape == (size,) and bool(np.all(np.isfinite(answers[size]))),
                  f"{size} finite logits")
        launches = {k.__name__: k.launches for k in kernels}
        print(f"launches over the three requests: {launches}")
        for name, count in launches.items():
            check(count > 0, f"{name} launched on the serving path")
        for size in (1, 1000):
            err, scale = rel_err(torch.as_tensor(answers[size]), torch.as_tensor(answers[BATCH][:size]))
            check(err <= LOGIT_REL_TOL * scale, f"request of {size} agrees with the batch of {BATCH}")
        cpu_pred = load_predictor(art, device="cpu")
        cpu = cpu_pred.predict_logits(batch.dense[:1024], batch.ids[:1024])
        err, scale = rel_err(torch.as_tensor(answers[BATCH][:1024]), torch.as_tensor(cpu))
        tol = LOGIT_REL_TOL * scale
        print(f"GPU vs CPU logits (1,024 requests): max err {err:.6g}, max |ref| {scale:.6g}, "
              f"tol {tol:.6g}")
        check(err <= tol, "GPU logits match the CPU plain path")
        for name, size in term_sizes(cpu_pred, batch.ids[:1024]).items():
            print(f"term {name}: max |contribution| {size:.6g} = {size / tol:.1f} x the logit tol")
            check(size >= TERM_MIN_TOLS * tol, f"{name} moves the logits by >= {TERM_MIN_TOLS} tols")
        del cpu_pred

        with torch.inference_mode():
            logits_ms = time_ms(lambda: pred.engine.logits(pred.state, dense, ids), iters=10)
        t_host = []
        for _ in range(5):
            t0 = time.perf_counter()
            pred.predict_logits(batch.dense, batch.ids)
            t_host.append(time.perf_counter() - t0)
        predict_ms = float(np.median(t_host)) * 1e3
        print(f"Engine.logits at {BATCH}: {logits_ms:.4f} ms device time, "
              f"{BATCH / logits_ms * 1e3:.0f} examples/s on {card}")
        print(f"predict_logits at {BATCH} (numpy in and out): {predict_ms:.4f} ms median of 5, "
              f"{BATCH / predict_ms * 1e3:.0f} examples/s on {card}")
        with torch.inference_mode():
            profile(lambda: pred.engine.logits(pred.state, dense, ids))

    del pred
    launches = training_phase(engine, schema, card, gen)

    kernel_rows = [
        {"name": name, "route": r["route"], "source": r["source"], "replaces": r["replaces"],
         "launches": launches[name], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
         "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
         "library_ms": r["library_ms"],
         **{k: v for k, v in r.items() if k.startswith("dim1_") or k == "also_replaces"}}
        for name, r in report.items()
    ]
    print(json.dumps({"kernels": kernel_rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


def training_phase(engine, schema, card: str, gen: torch.Generator) -> dict[str, int]:
    """Train full-width bf16 xDeepFM on the card; returns each kernel's
    launches over the TRAIN_STEPS steps (the counts are set to 0 just
    before them and read just after)."""
    from recmodels_tpu_torch.data import SyntheticSource
    from recmodels_tpu_torch.embedding.gather import gather_rows
    from recmodels_tpu_torch.embedding.update import sorted_adagrad_update
    from recmodels_tpu_torch.ops.cuda.interactions_cuda import (
        cin2_backward, cin2_forward, split_fused_rows, split_fused_rows_backward,
    )

    print("== training (full-width bf16 xDeepFM, Adam 1e-3 + sparse Adagrad 1e-2)")
    dev = torch.device("cuda")
    kernels = (gather_rows, split_fused_rows, cin2_forward, sorted_adagrad_update,
               split_fused_rows_backward, cin2_backward)
    src = iter(SyntheticSource(schema, batch_size=BATCH, seed=11))
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

    # one step from a live state on the card and on the CPU plain path
    liven(state, gen)
    dense, ids, labels = (t[:TRAIN_CHECK_BATCH] for t in batches[0])
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
    (gname,) = state.emb_params["emb"]
    table_b = before.emb_params["emb"][gname]
    acc_b = before.emb_opt["emb"][gname]["acc"]
    gpu_t, gpu_a = state.emb_params["emb"][gname].cpu(), state.emb_opt["emb"][gname]["acc"].cpu()
    cpu_t, cpu_a = cpu_state.emb_params["emb"][gname], cpu_state.emb_opt["emb"][gname]["acc"]
    touched = torch.zeros(table_b.shape[0], dtype=torch.bool)
    touched[engine.collections["emb"].group_row_ids(cpu_in[1])[gname].reshape(-1).long()] = True
    # the fused wide column's grads outgrow the embedding columns': each part
    # is held to its own largest change
    for part, cols in (("embedding columns", slice(0, -1)), ("wide column", slice(-1, None))):
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

    dense, ids, labels = batches[-1]
    step_ms = time_ms(lambda: engine.train_step(state, dense, ids, labels), iters=10)
    t_host = []
    for _ in range(5):
        t0 = time.perf_counter()
        engine.train_step(state, dense, ids, labels)
        torch.cuda.synchronize()
        t_host.append(time.perf_counter() - t0)
    host_ms = float(np.median(t_host)) * 1e3
    print(f"Engine.train_step at {BATCH}: {step_ms:.4f} ms per step (CUDA events, 10 back-to-back steps), "
          f"{BATCH / step_ms * 1e3:.0f} examples/s on {card}")
    print(f"Engine.train_step at {BATCH} one at a time (host clock to synchronize): {host_ms:.4f} ms "
          f"median of 5, {BATCH / host_ms * 1e3:.0f} examples/s on {card}")
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    busy = profile(lambda: engine.train_step(state, dense, ids, labels), top=20)
    print(f"Engine.train_step at {BATCH}: {busy:.4f} ms of kernel time per step (profiler), "
          f"{BATCH / busy * 1e3:.0f} examples/s if the host kept the card busy, on {card}")
    return launches


if __name__ == "__main__":
    sys.exit(main())
