"""Host-side (numpy) batches: ``Batch``, the frozen dense transform and the
synthetic Criteo-like stream.

The numbers are those of ``recmodels_tpu.data.criteo`` byte for byte: the
same seeds give the same arrays, so a test can feed one batch to both
packages. The Criteo TSV source and its native parser are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np

from recmodels_tpu_torch.data import hashing
from recmodels_tpu_torch.data.schema import Schema


@dataclasses.dataclass
class Batch:
    """One batch. dense: [B, n_dense] f32; ids: [B, n_slots] i32;
    labels: [B] f32 in {0, 1}."""

    dense: np.ndarray
    ids: np.ndarray
    labels: np.ndarray

    @property
    def size(self) -> int:
        return self.labels.shape[0]


def transform_dense(raw: np.ndarray) -> np.ndarray:
    """Frozen dense transform v1: log1p(max(x, 0)); missing (NaN) -> 0."""
    x = np.nan_to_num(raw.astype(np.float32), nan=0.0)
    return np.log1p(np.maximum(x, 0.0))


class SyntheticSource:
    """Deterministic synthetic Criteo-like stream with a planted signal.

    Labels are drawn from a ground-truth sparse-logistic + pairwise model over
    the hashed ids, so models can genuinely learn (loss decreases, AUC > 0.5).
    """

    def __init__(
        self,
        schema: Schema,
        batch_size: int,
        seed: int = 0,
        shard_index: int = 0,
        shard_count: int = 1,
        signal_dim: int = 4,
        task_seed: int = 0,
    ):
        """``seed`` controls the example stream; ``task_seed`` controls the
        planted ground-truth model. Train/validation sources must share
        ``task_seed`` (same task) while using different ``seed`` (disjoint
        examples)."""
        self.schema = schema
        self.batch_size = batch_size
        self.seed = seed
        self.shard_index = shard_index
        self.shard_count = shard_count
        self._step = 0
        rng = np.random.default_rng(task_seed + 1_000_003)
        self._dense_w = rng.normal(0, 0.6, size=(schema.n_dense,)).astype(np.float32)
        self._signal_dim = signal_dim
        self._slot_proj = rng.normal(0, 0.7, size=(schema.n_slots, signal_dim)).astype(np.float32)

    def state(self) -> dict:
        return {"step": self._step}

    def set_state(self, state: dict) -> None:
        self._step = int(state["step"])

    def _bucket_weight(self, ids: np.ndarray) -> np.ndarray:
        # pseudo-random but deterministic per (slot, bucket) scalar weight
        n_slots = self.schema.n_slots
        slot = np.broadcast_to(np.arange(n_slots, dtype=np.uint64), ids.shape)
        h = hashing.splitmix64(ids.astype(np.uint64) * np.uint64(2654435761) + slot * np.uint64(97531))
        u = (h >> np.uint64(11)).astype(np.float64) / float(1 << 53)
        return (u.astype(np.float32) - 0.5) * 2.0  # in [-1, 1)

    def _make(self, step: int) -> Batch:
        rng = np.random.default_rng(
            (self.seed * 0x9E3779B1 + step * self.shard_count + self.shard_index) & 0x7FFFFFFF
        )
        b = self.batch_size
        sch = self.schema
        raw_dense = rng.gamma(2.0, 20.0, size=(b, sch.n_dense)).astype(np.float32)
        dense = transform_dense(raw_dense)
        ids = np.stack(
            [rng.integers(0, v, size=(b,), dtype=np.int64) for v in sch.vocab_sizes], axis=1
        ).astype(np.int32)
        # planted logit: dense linear + per-bucket weights + low-rank pairwise
        logit = dense @ self._dense_w
        bw = self._bucket_weight(ids)
        logit += bw.sum(axis=1) * 0.5
        emb = bw[:, :, None] * self._slot_proj[None, :, :]  # [b, n_slots, k]
        s = emb.sum(axis=1)
        logit += 0.5 * ((s * s).sum(axis=1) - (emb * emb).sum(axis=(1, 2))) * 0.15
        logit = logit - logit.mean() if b > 1 else logit
        p = 1.0 / (1.0 + np.exp(-logit))
        labels = (rng.random(b) < p).astype(np.float32)
        return Batch(dense=dense, ids=ids, labels=labels)

    def __iter__(self) -> Iterator[Batch]:
        while True:
            batch = self._make(self._step)
            self._step += 1
            yield batch
