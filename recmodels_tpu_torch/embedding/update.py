"""Sparse Adagrad update from a sorted id stream: the CUDA kernel of
``csrc/adagrad_update.cu`` and its plain PyTorch version.

Counterpart of ``recmodels_tpu/embedding/pallas_update.py``
(``sorted_adagrad_update_packed`` and ``sorted_adagrad_update``). The port
keeps one table layout, a plain row-major ``[R, d]`` f32 table with its
accumulator (``[R]`` for dim-1 tables), and updates both in place.

Contract (both versions; ``pallas_update.py``'s docstring has the TPU side):
for each distinct id k < R of the ascending stream, the id's grads are
summed in f32 in stream order, then ``acc[k] += g*g`` and
``table[k] -= lr*g / (sqrt(acc[k]) + eps)``. Rows not in the stream are not
touched; ids >= R (sentinels) are skipped; bf16 grads widen exactly to f32.
The kernel rounds every operation as the CPU does (no FMA), so the two agree
bit for bit when they sum in the same order.
"""

from __future__ import annotations

import torch

from recmodels_tpu_torch.ops.cuda import build
from recmodels_tpu_torch.ops.cuda.launch import cuda_device, device_and_stream, require

GRAD_DTYPES = (torch.bfloat16, torch.float32)


def sorted_adagrad_update_reference(table: torch.Tensor, acc: torch.Tensor,
                                    sorted_ids: torch.Tensor, grads_sorted: torch.Tensor,
                                    lr: float, eps: float) -> None:
    """Plain version, in place: ``index_add_`` into zeros sums each run in
    stream order. The square root is taken in f64 and rounded to f32, which
    is the correctly rounded f32 root (the kernel's ``__fsqrt_rn``): the
    CPU's f32 ``torch.sqrt`` is a vectorised approximation that lands one
    ulp off for a few values in a thousand."""
    keep = (sorted_ids >= 0) & (sorted_ids < table.shape[0])
    ids = sorted_ids[keep].long()
    uids, inverse = torch.unique_consecutive(ids, return_inverse=True)
    g = grads_sorted[keep].float()
    gsum = torch.zeros((uids.numel(), *g.shape[1:]), dtype=torch.float32, device=g.device)
    gsum.index_add_(0, inverse, g)
    a = acc[uids] + gsum * gsum
    acc[uids] = a
    table[uids] = table[uids] - lr * gsum / (torch.sqrt(a.double()).float() + eps)


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
    require("sorted_adagrad_update grads", grads_sorted, GRAD_DTYPES, nd, dev_t, align=2)
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
