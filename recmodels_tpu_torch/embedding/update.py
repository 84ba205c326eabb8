"""Sparse updates from a sorted id stream: the CUDA kernels of
``csrc/adagrad_update.cu`` (Adagrad) and ``csrc/adam_update.cu`` (lazy Adam)
and their plain PyTorch versions.

Counterpart of ``recmodels_tpu/embedding/pallas_update.py``
(``sorted_adagrad_update_packed``, ``sorted_adagrad_update`` and
``sorted_adam_update_packed``). The port keeps one table layout, a plain
row-major ``[R, d]`` f32 table with its optimizer state (``[R]`` for dim-1
tables), and updates both in place.

Contract (all versions; ``pallas_update.py``'s docstring has the TPU side):
for each distinct id k < R of the ascending stream, the id's grads are
summed in f32 in stream order into g, then

* Adagrad: ``acc[k] += g*g`` and ``table[k] -= lr*g / (sqrt(acc[k]) + eps)``;
* lazy Adam: ``m[k] = b1*m[k] + (1-b1)*g``, ``v[k] = b2*v[k] + (1-b2)*g*g``
  and ``table[k] += (-lr*(m[k]/bc1)) / (sqrt(v[k]/bc2) + eps)``, in that
  order, with the bias corrections bc1 = 1 - b1^t and bc2 = 1 - b2^t given.
  A row is touched when its id is in the stream, so an id whose grads sum to
  0 still decays its moments.

Rows not in the stream are not touched; ids >= R (sentinels) are skipped;
bf16 grads widen exactly to f32. The kernels round every operation as the
CPU does (no FMA; the constants are the same f32 values), so kernel and
plain version agree bit for bit when they sum in the same order.

Both kernels are one template (``csrc/sorted_update_common.cuh``): a warp
takes 32 stream positions at a time, and a run of one id belongs to the
warp whose positions hold its first; that warp sums all of it in stream
order, past its 32 positions where the run goes on.
"""

from __future__ import annotations

import numpy as np
import torch

from recmodels_tpu_torch.ops.cuda import build
from recmodels_tpu_torch.ops.cuda.launch import cuda_device, device_and_stream, require

GRAD_DTYPES = (torch.bfloat16, torch.float32)


def _run_sums(table: torch.Tensor, sorted_ids: torch.Tensor, grads_sorted: torch.Tensor):
    """(distinct kept ids [U] int64, their grads summed in f32 in stream
    order [U, ...]): ``index_add_`` into zeros sums each run in order."""
    keep = (sorted_ids >= 0) & (sorted_ids < table.shape[0])
    ids = sorted_ids[keep].long()
    uids, inverse = torch.unique_consecutive(ids, return_inverse=True)
    g = grads_sorted[keep].float()
    gsum = torch.zeros((uids.numel(), *g.shape[1:]), dtype=torch.float32, device=g.device)
    gsum.index_add_(0, inverse, g)
    return uids, gsum


def _sqrt_f32(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded f32 square root (the kernels' ``__fsqrt_rn``):
    taken in f64 and rounded, since the CPU's f32 ``torch.sqrt`` is a
    vectorised approximation that lands one ulp off for a few values in a
    thousand."""
    return torch.sqrt(x.double()).float()


def sorted_adagrad_update_reference(table: torch.Tensor, acc: torch.Tensor,
                                    sorted_ids: torch.Tensor, grads_sorted: torch.Tensor,
                                    lr: float, eps: float) -> None:
    """Plain version, in place."""
    uids, gsum = _run_sums(table, sorted_ids, grads_sorted)
    a = acc[uids] + gsum * gsum
    acc[uids] = a
    table[uids] = table[uids] - lr * gsum / (_sqrt_f32(a) + eps)


def sorted_adagrad_update(table: torch.Tensor, acc: torch.Tensor, sorted_ids: torch.Tensor,
                          grads_sorted: torch.Tensor, lr: float, eps: float) -> None:
    """Update ``table`` and ``acc`` ([R, d] or [R] f32) in place from int32
    ``sorted_ids`` [N] (ascending, duplicates and sentinels >= R allowed)
    and ``grads_sorted`` ([N, d] or [N], bf16 or f32) in the same order.

    A CPU table takes the plain version; a CUDA table launches the kernel
    (or raises on what the kernel does not take)."""
    if table.device.type == "cpu":
        sorted_adagrad_update_reference(table, acc, sorted_ids, grads_sorted, lr, eps)
        return
    dev_t = cuda_device(table, "sorted_adagrad_update")
    nd = table.dim()
    if nd not in (1, 2):
        raise ValueError(f"sorted_adagrad_update: table {tuple(table.shape)}, expected [R, d] or [R]")
    require("sorted_adagrad_update table", table, (torch.float32,), nd, dev_t, align=4)
    require("sorted_adagrad_update acc", acc, (torch.float32,), nd, dev_t, align=4)
    require("sorted_adagrad_update ids", sorted_ids, (torch.int32,), 1, dev_t, align=4)
    require("sorted_adagrad_update grads", grads_sorted, GRAD_DTYPES, nd, dev_t,
            align=grads_sorted.element_size())
    d = 1 if nd == 1 else table.shape[1]
    n = sorted_ids.shape[0]
    if acc.shape != table.shape or grads_sorted.shape != (n, *table.shape[1:]):
        raise ValueError(
            f"sorted_adagrad_update: table {tuple(table.shape)}, acc {tuple(acc.shape)}, "
            f"ids {tuple(sorted_ids.shape)} and grads {tuple(grads_sorted.shape)} do not fit together"
        )
    dev, stream = device_and_stream(dev_t)
    err = build.library().rm_adagrad_update(
        dev, table.data_ptr(), acc.data_ptr(), sorted_ids.data_ptr(), grads_sorted.data_ptr(),
        n, table.shape[0], d, int(grads_sorted.dtype == torch.bfloat16), lr, eps, stream,
    )
    build.check(err, "sorted_adagrad_update")
    sorted_adagrad_update.launches += 1


sorted_adagrad_update.launches = 0  # kernel launches since the count was last set to 0


def bias_correction(decay: float, count: int) -> float:
    """1 - decay^count in f32 (optax's ``1 - decay**count`` and the JAX
    package's lazy Adam, both on an f32 decay and count)."""
    return float(np.float32(1.0) - np.float32(decay) ** np.float32(count))


def _f32(x: float) -> float:
    """``x`` rounded to the nearest f32, as a Python float (exact in f32)."""
    return float(np.float32(x))


def adam_constants(lr: float, bc1: float, bc2: float, b1: float, b2: float, eps: float) -> dict:
    """The f32 constants both lazy-Adam versions use: each value rounded to
    f32 once, with ``1 - b`` computed in double first, as JAX rounds the
    Python constants of ``optim.sparse_adam``."""
    return dict(lr=_f32(lr), bc1=_f32(bc1), bc2=_f32(bc2), b1=_f32(b1), one_minus_b1=_f32(1.0 - b1),
                b2=_f32(b2), one_minus_b2=_f32(1.0 - b2), eps=_f32(eps))


def sorted_adam_update_reference(table: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
                                 sorted_ids: torch.Tensor, grads_sorted: torch.Tensor, lr: float,
                                 bc1: float, bc2: float, b1: float, b2: float, eps: float) -> None:
    """Plain version of lazy Adam, in place, in the kernel's order of
    operations."""
    c = adam_constants(lr, bc1, bc2, b1, b2, eps)
    uids, gsum = _run_sums(table, sorted_ids, grads_sorted)
    mn = c["b1"] * m[uids] + c["one_minus_b1"] * gsum
    vn = c["b2"] * v[uids] + c["one_minus_b2"] * gsum * gsum
    m[uids] = mn
    v[uids] = vn
    num = -c["lr"] * (mn / c["bc1"])
    table[uids] = table[uids] + num / (_sqrt_f32(vn / c["bc2"]) + c["eps"])


def sorted_adam_update(table: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
                       sorted_ids: torch.Tensor, grads_sorted: torch.Tensor, lr: float,
                       bc1: float, bc2: float, b1: float, b2: float, eps: float) -> None:
    """Lazy Adam: update ``table``, ``m`` and ``v`` ([R, d] or [R] f32) in
    place from int32 ``sorted_ids`` [N] (ascending, duplicates and sentinels
    >= R allowed) and ``grads_sorted`` ([N, d] or [N], bf16 or f32) in the
    same order; ``bc1``/``bc2`` are the bias corrections of this step.

    A CPU table takes the plain version; a CUDA table launches the kernel
    (or raises on what the kernel does not take)."""
    if table.device.type == "cpu":
        sorted_adam_update_reference(table, m, v, sorted_ids, grads_sorted, lr, bc1, bc2, b1, b2, eps)
        return
    dev_t = cuda_device(table, "sorted_adam_update")
    nd = table.dim()
    if nd not in (1, 2):
        raise ValueError(f"sorted_adam_update: table {tuple(table.shape)}, expected [R, d] or [R]")
    for what, t in (("table", table), ("m", m), ("v", v)):
        require(f"sorted_adam_update {what}", t, (torch.float32,), nd, dev_t, align=4)
    require("sorted_adam_update ids", sorted_ids, (torch.int32,), 1, dev_t, align=4)
    require("sorted_adam_update grads", grads_sorted, GRAD_DTYPES, nd, dev_t,
            align=grads_sorted.element_size())
    n = sorted_ids.shape[0]
    if (m.shape != table.shape or v.shape != table.shape
            or grads_sorted.shape != (n, *table.shape[1:])):
        raise ValueError(
            f"sorted_adam_update: table {tuple(table.shape)}, m {tuple(m.shape)}, v {tuple(v.shape)}, "
            f"ids {tuple(sorted_ids.shape)} and grads {tuple(grads_sorted.shape)} do not fit together"
        )
    c = adam_constants(lr, bc1, bc2, b1, b2, eps)
    dev, stream = device_and_stream(dev_t)
    err = build.library().rm_adam_update(
        dev, table.data_ptr(), m.data_ptr(), v.data_ptr(), sorted_ids.data_ptr(),
        grads_sorted.data_ptr(), n, table.shape[0], 1 if nd == 1 else table.shape[1],
        int(grads_sorted.dtype == torch.bfloat16), c["lr"], c["bc1"], c["bc2"], c["b1"],
        c["one_minus_b1"], c["b2"], c["one_minus_b2"], c["eps"], stream,
    )
    build.check(err, "sorted_adam_update")
    sorted_adam_update.launches += 1


sorted_adam_update.launches = 0  # kernel launches since the count was last set to 0
