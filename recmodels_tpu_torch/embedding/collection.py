"""EmbeddingCollection: per-slot tables stacked into one matrix per dim group.

Port of ``recmodels_tpu/embedding/collection.py`` (its docstring has the
design): slots that share an embedding dim live in one ``[rows, dim]``
table, slot-local ids become global row ids by a per-slot offset, and groups
are reassembled into ``[B, n_slots, max_dim]``. Allocation and init rules
are the JAX package's: rows round up to ``ALLOC_MULTIPLE``, vector groups
start at N(0, 0.05), dim-1 groups start at zero and are stored 1-D.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from recmodels_tpu_torch.data.schema import Schema
from recmodels_tpu_torch.embedding.gather import gather_rows

ALLOC_MULTIPLE = 1024  # table rows round up to this (the artifact layout)


@dataclasses.dataclass(frozen=True)
class DimGroup:
    """Slots sharing one embedding dim, stacked into one table."""

    name: str
    dim: int
    slot_indices: tuple[int, ...]  # positions in schema.slots
    row_offsets: tuple[int, ...]  # per slot, offset into the stacked table
    total_rows: int  # logical rows (sum of vocabs)

    @property
    def alloc_rows(self) -> int:
        return -(-self.total_rows // ALLOC_MULTIPLE) * ALLOC_MULTIPLE


def build_groups(schema: Schema) -> tuple[DimGroup, ...]:
    by_dim: dict[int, list[int]] = {}
    for i, spec in enumerate(schema.slots):
        by_dim.setdefault(spec.embed_dim, []).append(i)
    groups = []
    for dim in sorted(by_dim):
        slots = by_dim[dim]
        offsets, acc = [], 0
        for s in slots:
            offsets.append(acc)
            acc += schema.slots[s].vocab_size
        groups.append(
            DimGroup(
                name=f"d{dim}",
                dim=dim,
                slot_indices=tuple(slots),
                row_offsets=tuple(offsets),
                total_rows=acc,
            )
        )
    return tuple(groups)


class EmbeddingCollection:
    """Stateless descriptor + functional ops over ``{group.name: table}``."""

    def __init__(self, schema: Schema):
        self.schema = schema
        self.groups = build_groups(schema)
        self.max_dim = schema.max_dim
        self._np_offsets = {
            g.name: np.asarray(g.row_offsets, dtype=np.int32) for g in self.groups
        }
        self._offsets: dict = {}  # (group, device) -> offsets tensor

    def init(self, generator: torch.Generator, device) -> Dict[str, torch.Tensor]:
        """Dim-1 groups start at zero, stored 1-D ``[rows]``; vector groups
        N(0, 0.05) ``[rows, dim]``, all f32 on ``device``."""
        params = {}
        for g in self.groups:
            s = 0.0 if g.dim == 1 else 0.05
            shape = (g.alloc_rows,) if g.dim == 1 else (g.alloc_rows, g.dim)
            params[g.name] = torch.randn(
                shape, generator=generator, device=device, dtype=torch.float32
            ) * s
        return params

    def param_shapes(self) -> Dict[str, tuple]:
        """Each group's table shape: ``(alloc_rows,)`` for dim 1, else
        ``(alloc_rows, dim)``."""
        return {g.name: ((g.alloc_rows,) if g.dim == 1 else (g.alloc_rows, g.dim)) for g in self.groups}

    def group_row_ids(self, ids: torch.Tensor) -> Dict[str, torch.Tensor]:
        """[B, n_slots] slot-local int32 ids -> per-group global row ids
        [B, n_g] int32.

        PRECONDITION: each slot-local id lies in [0, vocab_size) of its slot.
        The hashing pipeline guarantees it, and ``serve.Predictor`` refuses
        ids outside it; an id out of range would land in the next slot's
        rows (or past the table, which the gather does not check). Nothing
        here clamps."""
        out = {}
        for g in self.groups:
            key = (g.name, ids.device)
            if key not in self._offsets:
                self._offsets[key] = torch.as_tensor(self._np_offsets[g.name], device=ids.device)
            if g.slot_indices == tuple(range(ids.shape[1])):
                cols = ids
            else:
                cols = ids[:, list(g.slot_indices)]
            out[g.name] = cols + self._offsets[key][None, :]
        return out

    def gather_rows(self, params: Dict[str, torch.Tensor], gids: Dict[str, torch.Tensor],
                    dtype: torch.dtype | None = None) -> Dict[str, torch.Tensor]:
        """Per-group gather: {g: [B, n_g]} global row ids -> {g: [B, n_g,
        dim]} in ``dtype`` (default the tables', f32), through the row
        gather (``embedding/gather.py``: the kernel for CUDA tables, its
        plain version for CPU ones); dim-1 tables gather as one column."""
        out = {}
        for g in self.groups:
            t = params[g.name]
            out[g.name] = gather_rows(t.reshape(t.shape[0], -1), gids[g.name], dtype or t.dtype)
        return out

    def combine(self, rows: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Per-group rows -> [B, n_slots, max_dim], zero-padded. A single
        group is returned as it is. Differentiable: autograd's transpose is
        ``split_grad``."""
        if len(self.groups) == 1:
            return rows[self.groups[0].name]
        some = next(iter(rows.values()))
        out = torch.zeros(
            (some.shape[0], self.schema.n_slots, self.max_dim), dtype=some.dtype, device=some.device
        )
        for g in self.groups:
            out[:, list(g.slot_indices), : g.dim] = rows[g.name]
        return out

    def split_grad(self, emb_grad: torch.Tensor) -> Dict[str, torch.Tensor]:
        """[B, n_slots, max_dim] cotangent -> per-group [B, n_g, dim], the
        transpose of ``combine``."""
        return {g.name: emb_grad[:, list(g.slot_indices), : g.dim] for g in self.groups}

    def lookup(self, params: Dict[str, torch.Tensor], ids: torch.Tensor) -> torch.Tensor:
        """Inference-path lookup: [B, n_slots] slot-local ids -> [B, n_slots,
        max_dim]."""
        return self.combine(self.gather_rows(params, self.group_row_ids(ids)))

    def nbytes(self) -> int:
        """The tables' logical bytes (f32 rows of every slot's vocab)."""
        return sum(g.total_rows * g.dim * 4 for g in self.groups)
