"""Sparse row-wise embedding optimizers (port of
``recmodels_tpu/embedding/optim.py``; its docstring has the design).

Gradients touch only the rows of this step's ids, so Adagrad and lazy Adam
run on the id stream: sort the ids (a stable batched per-slot sort keeps
duplicates in ascending-example order), permute the grad rows to match, and
hand both to the sorted update (``embedding/update.py``: the CUDA kernel on
the card, its plain version on the CPU), which sums duplicates in stream
order and updates the table and its state in place.

* ``"adagrad"``: Adagrad's sparse update equals a dense Adagrad step:
  untouched rows keep their bits.
* ``"adam"``: lazy Adam. The moments of touched rows (ids in the stream,
  whatever their grads sum to) decay and update; untouched rows keep their
  bits. The bias corrections use the global step, as in the JAX package.

The global step is a 0-d int32 tensor and the learning rate a 0-d f32
tensor, both on the table's device: the bias corrections are computed there
(``update.bias_corrections``) and the kernels read lr and them from device
memory, so a CUDA graph of the training step replays each step's values.
* ``"adam_dense"``: dense Adam over the whole table, the JAX package's
  dense route: a dense f32 grad of the table's shape, then Adam on every
  row, so untouched rows decay too. The JAX package runs it in XLA with no
  kernel of its own, so plain PyTorch ops serve it on the card as well; the
  duplicate sum is ``index_put_(accumulate=True)``, which sums each id's
  grads in stream order on both devices, so two runs give the same bits.

Multi-hot groups (pooled bags, ``embedding/bag.py``): each id's grad is its
bag's pooled grad. ``bag_sorted_ids`` sorts the group's whole id batch in
one stable sort, so a row named in several hot columns of a slot and by
several examples is one run (sorting each column on its own would give it
one run a column, and the update kernel would write the row from two warps
at once), and gives the bag of each sorted position. ``apply_bag_updates``
hands the pooled grads and those bags to the same sorted update: on the
card, Adagrad's and lazy Adam's kernel reads each position's grad from its
bag's pooled row (``grad_index``), so the pooled grads are never expanded
to one row an id; dense Adam and CPU tables take the pooled grads expanded
along the sorted order (``index_select``), the same values in the same
order. The one-hot path is not changed.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, Sequence

import torch

from recmodels_tpu_torch.embedding.update import (
    adam_scalars, bias_corrections, device_constant, sorted_adagrad_update, sorted_adam_update,
)
from recmodels_tpu_torch.utils.profiling import annotate, count


def slot_sorted_ids(ids_2d: torch.Tensor):
    """Sort a [B, n_slots] batch of global row ids into one ascending stream
    by a stable per-slot sort (slots own disjoint, increasing row ranges, so
    the sorted columns concatenate into the global sort). Duplicates keep
    ascending-b order.

    Returns (sorted_ids [N] int32, order [N] int32, order_2d [ns, B] int32):
    ``order`` maps a sorted position to its position in the b-major flat
    stream ``ids_2d.reshape(-1)``."""
    b, ns = ids_2d.shape
    sorted_2d, order_2d = torch.sort(ids_2d.t(), dim=1, stable=True)
    order_2d = order_2d.to(torch.int32)
    slots = torch.arange(ns, dtype=torch.int32, device=ids_2d.device)[:, None]
    order = (order_2d * ns + slots).reshape(-1)
    return sorted_2d.reshape(-1), order, order_2d


def slot_sorted_inverse(order_2d: torch.Tensor) -> torch.Tensor:
    """Inverse permutation of ``slot_sorted_ids``: inv [N] (b-major) with
    inv[b*ns + s] = the sorted position of (b, s)."""
    ns, b = order_2d.shape
    inv_2d = torch.sort(order_2d, dim=1, stable=True)[1].to(torch.int32)
    offsets = (torch.arange(ns, dtype=torch.int32, device=order_2d.device) * b)[:, None]
    return (inv_2d + offsets).t().reshape(-1)


@functools.lru_cache(maxsize=None)
def bag_of_id(b: int, hotness: tuple, device: torch.device) -> torch.Tensor:
    """The bag of each id of a [b, sum(hotness)] batch in b-major order,
    ``example * n_bags + s``, [b * sum(hotness)] int32 on ``device``; made
    once a batch shape and never written (the first, eager step makes it,
    outside any CUDA graph capture)."""
    cols = torch.repeat_interleave(torch.arange(len(hotness)), torch.tensor(hotness))
    bags = torch.arange(b)[:, None] * len(hotness) + cols
    return bags.reshape(-1).to(device=device, dtype=torch.int32)


def bag_sorted_ids(ids_2d: torch.Tensor, hotness: Sequence[int]):
    """Sort a [B, n_ids] batch of a multi-hot group's global row ids into
    one ascending stream by one stable sort of the whole batch, so each row
    is one run, its positions in ascending b-major order (example, then
    column). Returns (sorted_ids [N] int32, bags [N] int32): the bag ``b *
    n_bags + s`` whose pooled grad each sorted position takes."""
    sorted_ids, order = torch.sort(ids_2d.reshape(-1), stable=True)
    bags = torch.index_select(bag_of_id(ids_2d.shape[0], tuple(hotness), ids_2d.device), 0, order)
    return sorted_ids, bags


def apply_bag_updates(opt: SparseOptimizer, table, state, ids_2d, pooled, hotness: Sequence[int],
                      step: torch.Tensor, lr: torch.Tensor, sorted_stream=None):
    """A multi-hot group's update, in place; returns the table and its
    state. ``ids_2d``: the [B, n_ids] global row ids; ``pooled``: the bags'
    grads [B, n_bags, dim]; ``sorted_stream``: ``bag_sorted_ids(ids_2d,
    hotness)`` when the caller has it. Each id takes its bag's grad. On a
    CUDA table Adagrad's and lazy Adam's kernels read it from the pooled
    grads through the sorted positions' bags (each such call adds 1 to the
    counter ``emb.bag_pooled_updates``); dense Adam and CPU tables take the
    pooled grads expanded along the sorted order (the span
    ``emb.bag_expand``). Either way the sorted stream goes to
    ``apply_sorted_updates``."""
    sorted_ids, bags = bag_sorted_ids(ids_2d, hotness) if sorted_stream is None else sorted_stream
    flat = pooled.reshape(-1, *table.shape[1:]).contiguous()
    if table.device.type == "cuda" and needs_sort(opt):
        count("emb.bag_pooled_updates", 1)
        return apply_sorted_updates(opt, table, state, sorted_ids, flat, step, lr, grad_index=bags)
    with annotate("emb.bag_expand"):
        grads = torch.index_select(flat, 0, bags)
    return apply_sorted_updates(opt, table, state, sorted_ids, grads, step, lr)


def dedup_segment_sum(gids: torch.Tensor, grads: torch.Tensor, num_rows: int):
    """Deduplicate row ids and sum their grad rows (in stable sorted order).

    gids [N] int32, grads [N, D] -> (uids [N] int32, summed [N, D], valid [N]
    bool): position k < U holds the k-th distinct id and its summed grad;
    positions k >= U hold the distinct ascending sentinels ``num_rows + k``
    and zero rows."""
    n = gids.shape[0]
    order = torch.argsort(gids, stable=True)
    sg = gids[order]
    gr = grads[order]
    is_start = torch.ones_like(sg, dtype=torch.bool)
    is_start[1:] = sg[1:] != sg[:-1]
    seg = torch.cumsum(is_start.long(), 0) - 1
    summed = torch.zeros((n, *grads.shape[1:]), dtype=grads.dtype, device=grads.device)
    summed.index_add_(0, seg, gr)
    counts = torch.zeros((n,), dtype=torch.long, device=gids.device)
    counts.index_add_(0, seg, torch.ones_like(seg))
    valid = counts > 0
    uids = torch.full((n,), torch.iinfo(torch.int32).min, dtype=gids.dtype, device=gids.device)
    uids = uids.scatter_reduce(0, seg, sg, reduce="amax")
    sentinels = num_rows + torch.arange(n, dtype=gids.dtype, device=gids.device)
    return torch.where(valid, uids, sentinels).to(torch.int32), summed, valid


@dataclasses.dataclass(frozen=True)
class SparseOptimizer:
    """Sparse optimizer over one stacked table, updated in place by
    ``apply_updates``. init(num_rows, dim, device) -> state dict; ``hyper``
    holds its hyperparameters (eps; b1, b2 for Adam)."""

    name: str
    init: Callable[..., Dict[str, torch.Tensor]]
    hyper: Dict[str, float]


def _adam_dense_update(table, state, ids_flat, grads_flat, step: torch.Tensor, lr: torch.Tensor,
                       h) -> None:
    """Dense Adam over the full table, in place, in the JAX package's order
    of operations (``optim.dense_adam``). Ids outside ``[0, rows)`` (the
    sharded owner's sentinels) are dropped, as JAX's ``mode="drop"``
    scatter drops them: their grads land in a spare row past the table."""
    b1, b2, eps = h["b1"], h["b2"], h["eps"]
    rows = table.shape[0]
    ids = ids_flat.long()
    ids = torch.where((ids >= 0) & (ids < rows), ids, rows)
    g = torch.zeros((rows + 1, *table.shape[1:]), dtype=torch.float32, device=table.device)
    g.index_put_((ids,), grads_flat.float(), accumulate=True)
    g = g[:rows]
    m, v = state["m"], state["v"]
    m.copy_(b1 * m + (1.0 - b1) * g)
    v.copy_(b2 * v + (1.0 - b2) * g * g)
    bc1, bc2 = bias_corrections(device_constant((b1, b2), step.device), step + 1).unbind()
    m_hat = m / bc1
    v_hat = v / bc2
    table.sub_(lr * m_hat / (torch.sqrt(v_hat) + eps))


def needs_sort(opt: SparseOptimizer) -> bool:
    """Whether ``apply_updates`` runs ``opt`` on the sorted id stream."""
    return opt.name != "adam_dense"


def apply_updates(opt: SparseOptimizer, table, state, ids_2d, grads_flat, step: torch.Tensor,
                  lr: torch.Tensor, sorted_stream=None):
    """One group's update, in place on ``table`` and ``state``; returns both.

    ``ids_2d``: the [B, n_g] global row ids; ``grads_flat``: their grad rows
    in b-major order, [B*n_g, dim] ([B*n_g] for a dim-1 table); ``step``:
    the global step before this update, a 0-d int32 tensor (Adam's bias
    corrections use t = step + 1); ``lr``: a 0-d f32 tensor; both on the
    table's device. Adagrad and lazy Adam take the per-slot sort
    (``sorted_stream``: ``slot_sorted_ids(ids_2d)``, when the caller has
    it already for another group of the same ids), the grad permute and the
    sorted-stream update (the CUDA kernels on the card); dense Adam takes
    the dense route."""
    if not needs_sort(opt):
        _adam_dense_update(table, state, ids_2d.reshape(-1), grads_flat, step, lr, opt.hyper)
        return table, state
    sorted_ids, order, _ = slot_sorted_ids(ids_2d) if sorted_stream is None else sorted_stream
    return apply_sorted_updates(opt, table, state, sorted_ids, torch.index_select(grads_flat, 0, order.long()),
                                step, lr)


def apply_sorted_updates(opt: SparseOptimizer, table, state, sorted_ids, grads_sorted, step: torch.Tensor,
                         lr: torch.Tensor, grad_index=None):
    """One group's update from an ascending id stream and its grads in the
    same order (the JAX package's ``apply_updates(..., presorted=True)``):
    the sharded owner's stream, whose tail may hold sentinels ``>= rows``,
    which every route skips. With ``grad_index`` (int32, one a position;
    Adagrad and lazy Adam only) ``grads_sorted`` are pooled grads read
    through it (``embedding/update.py``). In place; returns the table and
    its state."""
    h = opt.hyper
    if opt.name == "adam":
        sorted_adam_update(table, state["m"], state["v"], sorted_ids, grads_sorted,
                           adam_scalars(lr, step, h["b1"], h["b2"]), h["b1"], h["b2"], h["eps"], grad_index)
    elif opt.name == "adagrad":
        sorted_adagrad_update(table, state["acc"], sorted_ids, grads_sorted, lr, h["eps"], grad_index)
    elif grad_index is not None:
        raise ValueError("apply_sorted_updates: dense Adam takes its grads in stream order, not through an index")
    else:
        _adam_dense_update(table, state, sorted_ids, grads_sorted, step, lr, h)
    return table, state


def sparse_adagrad(eps: float = 1e-8, initial_accumulator: float = 0.1) -> SparseOptimizer:
    """Per-element Adagrad on touched rows (== dense Adagrad semantics)."""

    def init(num_rows: int, dim: int, device="cpu") -> Dict[str, torch.Tensor]:
        shape = (num_rows,) if dim == 1 else (num_rows, dim)
        return {"acc": torch.full(shape, initial_accumulator, dtype=torch.float32, device=device)}

    return SparseOptimizer("adagrad", init, {"eps": eps})


def _moments_init(num_rows: int, dim: int, device="cpu") -> Dict[str, torch.Tensor]:
    shape = (num_rows,) if dim == 1 else (num_rows, dim)
    return {"m": torch.zeros(shape, dtype=torch.float32, device=device),
            "v": torch.zeros(shape, dtype=torch.float32, device=device)}


def sparse_adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> SparseOptimizer:
    """Lazy Adam: moment updates and decay on touched rows only."""
    return SparseOptimizer("adam", _moments_init, {"b1": b1, "b2": b2, "eps": eps})


def dense_adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> SparseOptimizer:
    """Dense Adam over the full table every step: the moments of untouched
    rows decay too."""
    return SparseOptimizer("adam_dense", _moments_init, {"b1": b1, "b2": b2, "eps": eps})


def get_sparse_optimizer(name: str, **kwargs) -> SparseOptimizer:
    if name == "adagrad":
        return sparse_adagrad(**kwargs)
    if name == "adam":
        return sparse_adam(**kwargs)
    if name == "adam_dense":
        return dense_adam(**kwargs)
    raise ValueError(f"unknown sparse optimizer: {name}")
