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

The values that change from step to step come as f32 tensors on the table's
device, as the TPU kernels read them from a scalar operand: Adagrad's lr (one
value) and lazy Adam's block ``[lr, bc1, bc2]`` (``adam_scalars``, computed
there from the step tensor). The kernels read them from device memory and the
plain versions with tensor ops, so a CUDA graph of a step replays the values
of the step it runs. The optimizer's constants (eps; b1, b2) stay by value.

Rows not in the stream are not touched; ids >= R (sentinels) are skipped;
bf16 grads widen exactly to f32. The kernels round every operation as the
CPU does (no FMA; the constants are the same f32 values), so kernel and
plain version agree bit for bit when they sum in the same order.

The grads come one of two ways. A stream: ``grads`` [N, d] in the ids'
order. Pooled (``grad_index`` given, int32 [N]): ``grads`` [P, d] are a
multi-hot group's pooled bag grads and position j's grad is row
``grad_index[j]`` of them, which the kernels read where it lies, so the
expanded [N, d] stream is never written. The plain versions expand
(``index_select``) and run the stream's arithmetic, so a pooled kernel call
equals the plain update of the expanded stream bit for bit.

Both kernels are one template (``csrc/sorted_update_common.cuh``): a warp
takes 32 stream positions at a time, and a run of one id belongs to the
warp whose positions hold its first; that warp sums all of it in stream
order, past its 32 positions where the run goes on. Where the grads lie is
a template parameter: the stream's instances are the same code either way.
"""

from __future__ import annotations

import functools

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


def _require_index(what: str, table: torch.Tensor, sorted_ids: torch.Tensor, grads: torch.Tensor,
                   grad_index: torch.Tensor | None, device: torch.device):
    """Raise unless the grads (and ``grad_index``) fit the kernel; returns
    the index's address, or None (a stream of grads)."""
    if grad_index is not None:
        require(f"{what} grad_index", grad_index, (torch.int32,), 1, device, align=4)
    _check_grads(what, table, sorted_ids, grads, grad_index)
    return None if grad_index is None else grad_index.data_ptr()


def _require_scalars(what: str, t: torch.Tensor, n: int, device: torch.device) -> None:
    """Raise unless ``t`` holds ``n`` contiguous f32 values on ``device``."""
    if t.device != device or t.dtype != torch.float32 or t.numel() != n or not t.is_contiguous():
        raise ValueError(f"{what}: {n} contiguous f32 values on {device} expected, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")


def _check_grads(what: str, table: torch.Tensor, sorted_ids: torch.Tensor, grads: torch.Tensor,
                 grad_index: torch.Tensor | None) -> None:
    """Raise unless ``grads`` fit the table and the stream: [N, d] (``[N]``
    for a dim-1 table), or with ``grad_index`` an int32 [N] on the grads'
    device and pooled grads [P, d]."""
    n, row = sorted_ids.shape[0], tuple(table.shape[1:])
    if grad_index is None:
        fits = tuple(grads.shape) == (n, *row)
    else:
        if grad_index.dtype != torch.int32 or grad_index.device != grads.device:
            raise TypeError(f"{what}: grad_index {grad_index.dtype} on {grad_index.device}, expected "
                            f"int32 on {grads.device}")
        fits = tuple(grad_index.shape) == (n,) and grads.dim() == table.dim() and tuple(grads.shape[1:]) == row
    if not fits:
        index = "" if grad_index is None else f", grad_index {tuple(grad_index.shape)}"
        raise ValueError(f"{what}: table {tuple(table.shape)}, ids {tuple(sorted_ids.shape)}{index} and grads "
                         f"{tuple(grads.shape)} do not fit together")


def _stream_grads(what: str, table: torch.Tensor, sorted_ids: torch.Tensor, grads: torch.Tensor,
                  grad_index: torch.Tensor | None) -> torch.Tensor:
    """The plain versions' grads in stream order: ``grads`` as they are, or
    pooled grads expanded along ``grad_index``."""
    _check_grads(what, table, sorted_ids, grads, grad_index)
    return grads if grad_index is None else torch.index_select(grads, 0, grad_index)


def sorted_adagrad_update_reference(table: torch.Tensor, acc: torch.Tensor,
                                    sorted_ids: torch.Tensor, grads_sorted: torch.Tensor,
                                    lr: torch.Tensor, eps: float,
                                    grad_index: torch.Tensor | None = None) -> None:
    """Plain version, in place; ``lr`` a 0-d f32 tensor; pooled grads (with
    ``grad_index``) are expanded first."""
    grads_sorted = _stream_grads("sorted_adagrad_update", table, sorted_ids, grads_sorted, grad_index)
    uids, gsum = _run_sums(table, sorted_ids, grads_sorted)
    a = acc[uids] + gsum * gsum
    acc[uids] = a
    table[uids] = table[uids] - lr * gsum / (_sqrt_f32(a) + eps)


def sorted_adagrad_update(table: torch.Tensor, acc: torch.Tensor, sorted_ids: torch.Tensor,
                          grads_sorted: torch.Tensor, lr: torch.Tensor, eps: float,
                          grad_index: torch.Tensor | None = None) -> None:
    """Update ``table`` and ``acc`` ([R, d] or [R] f32) in place from int32
    ``sorted_ids`` [N] (ascending, duplicates and sentinels >= R allowed)
    and ``grads_sorted`` ([N, d] or [N], bf16 or f32) in the same order,
    at the learning rate ``lr``, a 0-d f32 tensor on the table's device.
    With ``grad_index`` (int32 [N], each position's row of ``grads_sorted``)
    the grads are pooled, [P, d] or [P], and read through it.

    A CPU table takes the plain version; a CUDA table launches the kernel
    (or raises on what the kernel does not take)."""
    if table.device.type == "cpu":
        sorted_adagrad_update_reference(table, acc, sorted_ids, grads_sorted, lr, eps, grad_index)
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
    _require_scalars("sorted_adagrad_update lr", lr, 1, dev_t)
    index = _require_index("sorted_adagrad_update", table, sorted_ids, grads_sorted, grad_index, dev_t)
    d = 1 if nd == 1 else table.shape[1]
    n = sorted_ids.shape[0]
    if acc.shape != table.shape:
        raise ValueError(f"sorted_adagrad_update: table {tuple(table.shape)} and acc {tuple(acc.shape)} differ")
    dev, stream = device_and_stream(dev_t)
    err = build.library().rm_adagrad_update(
        dev, table.data_ptr(), acc.data_ptr(), sorted_ids.data_ptr(), grads_sorted.data_ptr(), index,
        n, table.shape[0], d, int(grads_sorted.dtype == torch.bfloat16), lr.data_ptr(), eps, stream,
    )
    build.check(err, "sorted_adagrad_update")
    sorted_adagrad_update.launches += 1


sorted_adagrad_update.launches = 0  # kernel launches since the count was last set to 0


@functools.lru_cache(maxsize=None)
def device_constant(values, device: torch.device) -> torch.Tensor:
    """``values`` (a float, or a tuple of them) as f32 on ``device``, made
    once a device and never written: the constants a step reads from device
    memory (the sparse lr, Adam's decays). The first, eager step makes them,
    outside any CUDA graph capture."""
    return torch.tensor(values, dtype=torch.float32, device=device)


def bias_corrections(decays: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """``1 - decays**count`` in f32 on the tensors' device, from an integer
    ``count`` tensor: optax's ``1 - decay**count`` and the JAX package's lazy
    Adam (``1 - b1**t``), both on f32 decays and an f32 count. Read from the
    count where it lies, so a CUDA graph replays its own step's values."""
    return 1.0 - torch.pow(decays, count)


def adam_scalars(lr: torch.Tensor, step: torch.Tensor, b1: float, b2: float) -> torch.Tensor:
    """Lazy Adam's f32 block ``[lr, bc1, bc2]`` on the step tensor's device:
    bc = 1 - b^t at t = step + 1 (``step``: the 0-d int32 global step before
    the update; ``lr``: a 0-d f32 tensor), as ``pallas_update.py`` builds
    its ``[lr, 1-b1^t, 1-b2^t, 0]`` operand."""
    decays = device_constant((b1, b2), step.device)
    return torch.cat((lr.reshape(1), bias_corrections(decays, step + 1)))


def _f32(x: float) -> float:
    """``x`` rounded to the nearest f32, as a Python float (exact in f32)."""
    return float(np.float32(x))


def adam_constants(b1: float, b2: float, eps: float) -> dict:
    """The by-value f32 constants both lazy-Adam versions use: each value
    rounded to f32 once, with ``1 - b`` computed in double first, as JAX
    rounds the Python constants of ``optim.sparse_adam``."""
    return dict(b1=_f32(b1), one_minus_b1=_f32(1.0 - b1), b2=_f32(b2), one_minus_b2=_f32(1.0 - b2),
                eps=_f32(eps))


def sorted_adam_update_reference(table: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
                                 sorted_ids: torch.Tensor, grads_sorted: torch.Tensor,
                                 scalars: torch.Tensor, b1: float, b2: float, eps: float,
                                 grad_index: torch.Tensor | None = None) -> None:
    """Plain version of lazy Adam, in place, in the kernel's order of
    operations; ``scalars`` the f32 block [lr, bc1, bc2]; pooled grads (with
    ``grad_index``) are expanded first."""
    grads_sorted = _stream_grads("sorted_adam_update", table, sorted_ids, grads_sorted, grad_index)
    c = adam_constants(b1, b2, eps)
    lr, bc1, bc2 = scalars.unbind()
    uids, gsum = _run_sums(table, sorted_ids, grads_sorted)
    mn = c["b1"] * m[uids] + c["one_minus_b1"] * gsum
    vn = c["b2"] * v[uids] + c["one_minus_b2"] * gsum * gsum
    m[uids] = mn
    v[uids] = vn
    num = -lr * (mn / bc1)
    table[uids] = table[uids] + num / (_sqrt_f32(vn / bc2) + c["eps"])


def sorted_adam_update(table: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
                       sorted_ids: torch.Tensor, grads_sorted: torch.Tensor,
                       scalars: torch.Tensor, b1: float, b2: float, eps: float,
                       grad_index: torch.Tensor | None = None) -> None:
    """Lazy Adam: update ``table``, ``m`` and ``v`` ([R, d] or [R] f32) in
    place from int32 ``sorted_ids`` [N] (ascending, duplicates and sentinels
    >= R allowed) and ``grads_sorted`` ([N, d] or [N], bf16 or f32) in the
    same order; ``scalars`` is this step's f32 block [lr, bc1, bc2] on the
    table's device (``adam_scalars``). With ``grad_index`` (int32 [N]) the
    grads are pooled, [P, d] or [P], as in ``sorted_adagrad_update``.

    A CPU table takes the plain version; a CUDA table launches the kernel
    (or raises on what the kernel does not take)."""
    if table.device.type == "cpu":
        sorted_adam_update_reference(table, m, v, sorted_ids, grads_sorted, scalars, b1, b2, eps, grad_index)
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
    _require_scalars("sorted_adam_update scalars", scalars, 3, dev_t)
    index = _require_index("sorted_adam_update", table, sorted_ids, grads_sorted, grad_index, dev_t)
    n = sorted_ids.shape[0]
    if m.shape != table.shape or v.shape != table.shape:
        raise ValueError(f"sorted_adam_update: table {tuple(table.shape)}, m {tuple(m.shape)} and "
                         f"v {tuple(v.shape)} differ")
    c = adam_constants(b1, b2, eps)
    dev, stream = device_and_stream(dev_t)
    err = build.library().rm_adam_update(
        dev, table.data_ptr(), m.data_ptr(), v.data_ptr(), sorted_ids.data_ptr(),
        grads_sorted.data_ptr(), index, n, table.shape[0], 1 if nd == 1 else table.shape[1],
        int(grads_sorted.dtype == torch.bfloat16), scalars.data_ptr(), c["b1"],
        c["one_minus_b1"], c["b2"], c["one_minus_b2"], c["eps"], stream,
    )
    build.check(err, "sorted_adam_update")
    sorted_adam_update.launches += 1


sorted_adam_update.launches = 0  # kernel launches since the count was last set to 0
