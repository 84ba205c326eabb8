"""Host-side (numpy) batches: ``Batch``, the frozen dense transform, the
Criteo TSV parsers and source, and the synthetic Criteo-like stream.

The numbers are those of ``recmodels_tpu.data.criteo`` byte for byte: the
same seeds, lines and cursors give the same arrays, so a test can feed one
batch to both packages. Sources are checkpointable: ``state()`` and
``set_state()`` carry the cursor, so a run resumes on the examples it had
not consumed.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterator, Sequence

import numpy as np

from recmodels_tpu_torch.data import hashing
from recmodels_tpu_torch.data.schema import N_CATEGORICAL, N_DENSE, Schema


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


def parse_criteo_lines(lines: Sequence[bytes], schema: Schema) -> Batch:
    """Parse raw TSV lines (label \\t 13 ints \\t 26 hex tokens) -> Batch, in
    Python."""
    n = len(lines)
    labels = np.zeros((n,), dtype=np.float32)
    dense = np.full((n, N_DENSE), np.nan, dtype=np.float32)
    fps = np.zeros((n, N_CATEGORICAL), dtype=np.uint64)
    missing = np.ones((n, N_CATEGORICAL), dtype=bool)
    for r, line in enumerate(lines):
        parts = line.rstrip(b"\n").split(b"\t")
        labels[r] = float(parts[0])
        for j in range(N_DENSE):
            tok = parts[1 + j] if 1 + j < len(parts) else b""
            if tok:
                dense[r, j] = float(tok)
        for j in range(N_CATEGORICAL):
            k = 1 + N_DENSE + j
            tok = parts[k] if k < len(parts) else b""
            if tok:
                missing[r, j] = False
                fps[r, j] = hashing.token_fingerprint(tok)
    slot_ids = np.broadcast_to(np.arange(N_CATEGORICAL), fps.shape)
    ids = hashing.hash_fingerprints(fps, missing, slot_ids, np.asarray(schema.vocab_sizes, np.int64))
    return Batch(dense=transform_dense(dense), ids=ids, labels=labels)


def parse_criteo_batch(lines: Sequence[bytes], schema: Schema, use_native: bool = True) -> Batch:
    """Parse a batch of raw lines with the native parser
    (``data/fastparse.py``; a failed build raises), or in Python when
    ``use_native`` is False."""
    if not use_native:
        return parse_criteo_lines(list(lines), schema)
    from recmodels_tpu_torch.data import fastparse

    buf = b"".join(l if l.endswith(b"\n") else l + b"\n" for l in lines)
    labels, dense, ids, _ = fastparse.parse_buffer(buf, schema, len(lines))
    if len(labels) != len(lines):
        raise ValueError(f"the native parser read {len(labels)} of {len(lines)} lines")
    return Batch(dense=dense, ids=ids, labels=labels)


class CriteoTSVSource:
    """Streams batches from a Criteo TSV file, sharded, checkpointable.

    ``shard_index``/``shard_count`` shard the rows round-robin: shard h takes
    the rows whose index is h modulo ``shard_count``. ``loop`` restarts the
    file at its end; ``shuffle_buffer > 1`` shuffles within a window of that
    many rows, deterministically from (seed, epoch), so a resumed cursor
    replays the same order. Lines go through the native parser.
    ``state()`` counts the rows of this shard already emitted."""

    def __init__(
        self,
        path: str,
        schema: Schema,
        batch_size: int,
        shard_index: int = 0,
        shard_count: int = 1,
        loop: bool = False,
        shuffle_buffer: int = 0,
        seed: int = 0,
    ):
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        if schema.multi_hot:
            raise NotImplementedError(
                f"a Criteo TSV row holds one id a slot; this schema's slots hold bags of {schema.hotness} ids")
        self.path = path
        self.schema = schema
        self.batch_size = batch_size
        self.shard_index = shard_index
        self.shard_count = shard_count
        self.loop = loop
        self.shuffle_buffer = shuffle_buffer
        self.seed = seed
        self._rows_consumed = 0  # rows of this shard already emitted

    def state(self) -> dict:
        return {"rows_consumed": self._rows_consumed}

    def set_state(self, state: dict) -> None:
        self._rows_consumed = int(state["rows_consumed"])

    def _shard_lines(self) -> Iterator[bytes]:
        """This shard's rows, in deterministic (possibly shuffled) order."""
        epoch = 0
        while True:
            if self.shuffle_buffer > 1:
                rng = np.random.default_rng((self.seed ^ 0x5EED) + 7919 * epoch)
                window: list[bytes] = []
                with open(self.path, "rb") as f:
                    for i, line in enumerate(f):
                        if i % self.shard_count != self.shard_index:
                            continue
                        window.append(line)
                        if len(window) >= self.shuffle_buffer:
                            j = int(rng.integers(0, len(window)))
                            window[j], window[-1] = window[-1], window[j]
                            yield window.pop()
                rng.shuffle(window)
                yield from window
            else:
                with open(self.path, "rb") as f:
                    for i, line in enumerate(f):
                        if i % self.shard_count == self.shard_index:
                            yield line
            epoch += 1
            if not self.loop:
                return

    def __iter__(self) -> Iterator[Batch]:
        skip = self._rows_consumed
        buf: list[bytes] = []
        for line in self._shard_lines():
            if skip > 0:
                skip -= 1
                continue
            buf.append(line)
            if len(buf) == self.batch_size:
                self._rows_consumed += len(buf)
                yield parse_criteo_batch(buf, self.schema)
                buf = []
        if buf:
            self._rows_consumed += len(buf)
            yield parse_criteo_batch(buf, self.schema)


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


def make_batch_iterator(source, drop_remainder: bool = True) -> Iterator[Batch]:
    """The source's batches; with ``drop_remainder`` only full ones (one
    batch shape, one CUDA graph)."""
    for batch in source:
        if drop_remainder and batch.size != source.batch_size:
            continue
        yield batch
