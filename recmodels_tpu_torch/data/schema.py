"""Feature schema for Criteo-style CTR logs.

Capability parity: the reference repo's feature pipeline (SURVEY.md §2a #7)
parses Criteo TSV rows into 13 dense features (log-ish transform) and 26
categorical slots hashed into fixed vocab buckets with per-slot embedding
dims. This module is the single source of truth for that spec — the hashing
and transform choices here are FROZEN (SURVEY.md §7 hard part 7: preprocessing
moves AUC more than model code, so it must not drift between runs).

Frozen data spec v1:
  * dense transform: ``log1p(max(x, 0))``, missing -> 0.0
  * categorical: missing -> bucket 0; present token -> ``1 + h % (V - 1)``
    where ``h = splitmix64(token_fingerprint ^ slot_salt)`` (see hashing.py)
  * slot salt for slot i: ``splitmix64(i + 1)``

Multi-hot slots: a slot of ``hotness`` h holds a bag of h ids an example
(DLRM's pooled embedding bags: MLPerf Training's DLRM-DCNv2 reads 1 to 100
ids a slot), summed into one row. A batch's ids are then ``[B, n_ids]``,
``n_ids`` the sum of the hotness, slot-major: slot 0's h_0 columns, then
slot 1's, and so on (``Schema.id_slots`` names each column's slot). With
every hotness at 1, ``n_ids == n_slots`` and column j is slot j.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

N_DENSE = 13
N_CATEGORICAL = 26


@dataclasses.dataclass(frozen=True)
class FeatureSpec:
    """One categorical slot: its hash-bucket vocab size and embedding dim;
    one id an example (``MultiHotSpec`` holds a bag)."""

    name: str
    vocab_size: int
    embed_dim: int
    hotness = 1  # ids an example holds in the slot; no field, so the spec is the JAX package's

    def __post_init__(self):
        if self.vocab_size < 2:
            raise ValueError(f"{self.name}: vocab_size must be >= 2 (bucket 0 is reserved for missing)")
        if self.embed_dim < 1:
            raise ValueError(f"{self.name}: embed_dim must be >= 1")


@dataclasses.dataclass(frozen=True)
class MultiHotSpec(FeatureSpec):
    """A slot that holds a bag of ``hotness`` ids an example, sum-pooled."""

    hotness: int = 1

    def __post_init__(self):
        super().__post_init__()
        if self.hotness < 1:
            raise ValueError(f"{self.name}: hotness must be >= 1")


def slot_spec(name: str, vocab_size: int, embed_dim: int, hotness: int = 1) -> FeatureSpec:
    """A ``FeatureSpec``, or a ``MultiHotSpec`` where ``hotness`` is not 1."""
    if hotness == 1:
        return FeatureSpec(name, vocab_size, embed_dim)
    return MultiHotSpec(name, vocab_size, embed_dim, hotness)


@dataclasses.dataclass(frozen=True)
class Schema:
    """Full input schema: dense width + ordered categorical slot specs."""

    n_dense: int
    slots: tuple[FeatureSpec, ...]

    @property
    def n_slots(self) -> int:
        return len(self.slots)

    @property
    def vocab_sizes(self) -> tuple[int, ...]:
        return tuple(s.vocab_size for s in self.slots)

    @property
    def embed_dims(self) -> tuple[int, ...]:
        return tuple(s.embed_dim for s in self.slots)

    @property
    def max_dim(self) -> int:
        return max(s.embed_dim for s in self.slots)

    @property
    def uniform_dim(self) -> bool:
        return len(set(self.embed_dims)) == 1

    def total_vocab(self) -> int:
        return sum(self.vocab_sizes)

    @property
    def hotness(self) -> tuple[int, ...]:
        return tuple(s.hotness for s in self.slots)

    @property
    def multi_hot(self) -> bool:
        """Whether some slot holds a bag of more than one id."""
        return any(s.hotness > 1 for s in self.slots)

    @property
    def n_ids(self) -> int:
        """Id columns of a batch: the sum of the slots' hotness."""
        return sum(self.hotness)

    @property
    def id_slots(self) -> tuple[int, ...]:
        """The slot of each id column, slot-major."""
        return tuple(i for i, s in enumerate(self.slots) for _ in range(s.hotness))

    @property
    def id_vocab_sizes(self) -> tuple[int, ...]:
        """The vocab of each id column's slot."""
        return tuple(self.slots[i].vocab_size for i in self.id_slots)


def criteo_schema(
    vocab_size: int | Sequence[int] = 100_000,
    embed_dim: int | Sequence[int] = 16,
    hotness: int | Sequence[int] = 1,
) -> Schema:
    """The Criteo display-ads schema: 13 dense ints + 26 hashed categorical.

    ``vocab_size``/``embed_dim`` may be scalars (uniform, matching
    BASELINE.json:7-8 "hashed 1e5 vocab", "dim-16 embeddings") or per-slot
    sequences of length 26 (BASELINE.json:9 "per-slot embedding dims");
    ``hotness`` likewise (MLPerf's multi-hot Criteo 1TB: per-slot bags).
    """
    if isinstance(vocab_size, int):
        vocab_size = (vocab_size,) * N_CATEGORICAL
    if isinstance(embed_dim, int):
        embed_dim = (embed_dim,) * N_CATEGORICAL
    if isinstance(hotness, int):
        hotness = (hotness,) * N_CATEGORICAL
    if len(vocab_size) != N_CATEGORICAL or len(embed_dim) != N_CATEGORICAL or len(hotness) != N_CATEGORICAL:
        raise ValueError("need 26 vocab sizes / embed dims / hotness values for Criteo")
    slots = tuple(
        slot_spec(f"C{i + 1}", int(v), int(d), int(h))
        for i, (v, d, h) in enumerate(zip(vocab_size, embed_dim, hotness))
    )
    return Schema(n_dense=N_DENSE, slots=slots)


def per_slot_dims_for_vocab(vocab_sizes: Sequence[int], base_dim: int = 16) -> tuple[int, ...]:
    """Heuristic per-slot dims: smaller vocab -> smaller dim, capped at base.

    Mirrors the reference's per-slot-dim capability (BASELINE.json:9) with a
    standard ``min(base, ~ 6 * V**0.25)`` rule rounded to a multiple of 4.
    """
    dims = []
    for v in vocab_sizes:
        d = min(base_dim, max(4, int(6 * v ** 0.25)))
        dims.append(((d + 3) // 4) * 4)
    return tuple(dims)
