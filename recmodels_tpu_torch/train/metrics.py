"""Streaming, mergeable evaluation metrics: ROC-AUC and logloss (port of
``recmodels_tpu/train/metrics.py``; its docstring has the design).

The state is a fixed-bin score histogram: positives and negatives counted
over K bins of sigmoid(logit), with the BCE summed beside them. States add
exactly, so shards or batches merge by ``auc_merge``; AUC is
``sum_k pos_k (cumneg_{<k} + neg_k / 2) / (P N)``, whose bias against the
exact AUC is O(1/K).

As in the JAX package: counts are int32 (exact to 2^31 a bin, where f32
counts stop at 2^24); a bin is ``int32(p * K)`` clipped to [0, K-1], with
``p = 1 / (1 + exp(-z))`` in f32, the formula of JAX's ``sigmoid``; the loss
is JAX's BCE form ``max(z, 0) - z*y + log1p(exp(-|z|))`` summed in f32;
weights are 0/1 masks for padded tail rows; ``auc_compute`` finalises on the host in float64, with
the example count taken from the histograms.

The one difference: ``exp(-z)`` is taken in f64 and rounded to f32, so it
is the correctly rounded f32 exp on the card and on the CPU alike, and the
card's histograms are the CPU's bit for bit. Each f32 ``exp`` of its own
(the card's, the CPU's vector one, XLA's) lands an ulp off for some
inputs, and that moves an example to the next bin only when p lies within
an ulp of a bin edge: at K = 16,384 a bin holds 2^10 f32 values of p in
[1/2, 1) and more below, so at most one example in a thousand of those
whose sigmoids differ. A bin is 1/K of the score range, so the AUC moves by at
most that share of those examples.

``auc_update`` adds a batch into the state's tensors in place and returns
the state. The histograms are built by ``index_add_`` into the fixed [K]
tensors: ``torch.bincount`` reads its maximum back to the host to size its
output, which a CUDA graph cannot capture. Integer atomics add exactly, so
the counts have the same bits on every run.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

DEFAULT_BINS = 16384


class AUCState(NamedTuple):
    """Streaming AUC + logloss state; the tensors of two states add."""

    pos_hist: torch.Tensor  # int32 [K] exact counts
    neg_hist: torch.Tensor  # int32 [K]
    loss_sum: torch.Tensor  # f32 0-d, the sum of BCE
    count: torch.Tensor  # int32 0-d, n


def auc_init(n_bins: int = DEFAULT_BINS, device="cuda") -> AUCState:
    """An empty state of ``n_bins`` bins on ``device``; raises for CUDA when
    no card is present, as ``Engine.init`` does."""
    from recmodels_tpu_torch.train.engine import resolve_device  # engine imports this module

    device = resolve_device(device)
    return AUCState(
        pos_hist=torch.zeros((n_bins,), dtype=torch.int32, device=device),
        neg_hist=torch.zeros((n_bins,), dtype=torch.int32, device=device),
        loss_sum=torch.zeros((), dtype=torch.float32, device=device),
        count=torch.zeros((), dtype=torch.int32, device=device),
    )


def auc_update(state: AUCState, logits: torch.Tensor, labels: torch.Tensor,
               weight: torch.Tensor | None = None) -> AUCState:
    """Accumulate a batch, in place: logits [B] f32, labels [B] in {0, 1},
    ``weight`` (if given) a [B] 0/1 mask for padded tail rows. Returns
    ``state``."""
    n_bins = state.pos_hist.shape[0]
    logits = logits.float()
    p = 1.0 / (1.0 + torch.exp(-logits.double()).float())
    idx = torch.clamp((p * n_bins).to(torch.int32), 0, n_bins - 1)
    w = torch.ones_like(labels) if weight is None else weight
    wi = w.to(torch.int32)
    li = (labels > 0.5).to(torch.int32)
    state.pos_hist.index_add_(0, idx, li * wi)
    state.neg_hist.index_add_(0, idx, (1 - li) * wi)
    bce = torch.clamp_min(logits, 0) - logits * labels + torch.log1p(torch.exp(-torch.abs(logits)))
    state.loss_sum.add_(torch.sum(bce * w.to(bce.dtype)))
    state.count.add_(torch.sum(wi, dtype=torch.int32))
    return state


def auc_merge(a: AUCState, b: AUCState) -> AUCState:
    """A new state, the sum of two."""
    return AUCState(*(x + y for x, y in zip(a, b)))


def auc_compute(state: AUCState) -> dict:
    """Finalise on the host in float64: {'auc', 'logloss', 'accuracy',
    'count'}. The denominator is the histograms' total, not ``count`` (an
    int32 that wraps past 2^31 examples while each bin stays exact).
    Accuracy is at the 0.5 threshold, from the same histograms."""
    pos = state.pos_hist.detach().cpu().numpy().astype(np.float64)
    neg = state.neg_hist.detach().cpu().numpy().astype(np.float64)
    total_pos = pos.sum()
    total_neg = neg.sum()
    cum_neg = np.cumsum(neg) - neg  # negatives strictly below this bin
    wins = float((pos * (cum_neg + 0.5 * neg)).sum())
    auc = wins / max(total_pos * total_neg, 1.0)
    count = float(total_pos + total_neg)
    logloss = float(state.loss_sum.detach().cpu()) / max(count, 1.0)
    half = pos.shape[0] // 2  # bin index of score 0.5
    correct = pos[half:].sum() + neg[:half].sum()
    accuracy = correct / max(total_pos + total_neg, 1.0)
    return {"auc": np.float64(auc), "logloss": np.float64(logloss),
            "accuracy": np.float64(accuracy), "count": count}
