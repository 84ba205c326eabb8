"""Sparse row-wise embedding optimizers (port of
``recmodels_tpu/embedding/optim.py``; its docstring has the design).

Gradients touch only the rows of this step's ids, so the update runs on the
id stream: sort the ids (a stable batched per-slot sort keeps duplicates in
ascending-example order), permute the grad rows to match, and hand both to
the sorted Adagrad update (``embedding/update.py``: the CUDA kernel on the
card, its plain version on the CPU), which sums duplicates in stream order
and updates the table and its accumulator in place. Adagrad's sparse update
equals a dense Adagrad step: untouched rows keep their bits.

Lazy Adam (``"adam"``) and dense Adam (``"adam_dense"``) arrive with their
kernel in a later slice, and with them the routes of the JAX package's
``apply_updates`` for optimizers without a sorted-stream kernel (the dense
full-table update and the ``dedup_segment_sum`` + sparse apply).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import torch

from recmodels_tpu_torch.embedding.update import sorted_adagrad_update

_ADAM_LATER = (
    "sparse optimizer {!r} is not ported yet: lazy and dense Adam come with the "
    "sorted_adam_update_packed kernel, ROADMAP.md queue 2 #7"
)


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
    ``apply_updates``. init(num_rows, dim, device) -> state dict."""

    name: str
    init: Callable[..., Dict[str, torch.Tensor]]
    eps: float


def apply_updates(opt: SparseOptimizer, table, state, ids_2d, grads_flat, lr):
    """One group's Adagrad update, in place on ``table`` and ``state``: the
    per-slot sort, the grad rows permuted to match, and the sorted-stream
    update (the CUDA kernel on the card).

    ``ids_2d``: the [B, n_g] global row ids; ``grads_flat``: their grad rows
    in b-major order, [B*n_g, dim] ([B*n_g] for a dim-1 table)."""
    sorted_ids, order, _ = slot_sorted_ids(ids_2d)
    grads_sorted = torch.index_select(grads_flat, 0, order.long())
    sorted_adagrad_update(table, state["acc"], sorted_ids, grads_sorted, lr, opt.eps)
    return table, state


def sparse_adagrad(eps: float = 1e-8, initial_accumulator: float = 0.1) -> SparseOptimizer:
    """Per-element Adagrad on touched rows (== dense Adagrad semantics)."""

    def init(num_rows: int, dim: int, device="cpu") -> Dict[str, torch.Tensor]:
        shape = (num_rows,) if dim == 1 else (num_rows, dim)
        return {"acc": torch.full(shape, initial_accumulator, dtype=torch.float32, device=device)}

    return SparseOptimizer("adagrad", init, eps)


def get_sparse_optimizer(name: str, **kwargs) -> SparseOptimizer:
    if name == "adagrad":
        return sparse_adagrad(**kwargs)
    if name in ("adam", "adam_dense"):
        raise NotImplementedError(_ADAM_LATER.format(name))
    raise ValueError(f"unknown sparse optimizer: {name}")
