"""EmbeddingCollection: per-slot tables stacked into one matrix per dim group.

Port of ``recmodels_tpu/embedding/collection.py`` (its docstring has the
design): slots that share an embedding dim live in one ``[rows, dim]``
table, slot-local ids become global row ids by a per-slot offset, and groups
are reassembled into ``[B, n_slots, max_dim]``. Allocation and init rules
are the JAX package's: rows round up to ``ALLOC_MULTIPLE``, vector groups
start at N(0, 0.05), dim-1 groups start at zero and are stored 1-D.

Multi-hot slots (``FeatureSpec.hotness`` > 1, the port's own: the JAX
package has none) hold a bag of ids an example: a batch is ``[B, n_ids]``
slot-major, a group's global ids are its slots' columns with each slot's
row offset repeated over its columns, and the group's rows are each bag's
rows summed (``embedding/bag.py``), ``[B, n_g, dim]`` as for one-hot slots.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from recmodels_tpu_torch.data.schema import Schema
from recmodels_tpu_torch.embedding.bag import bag_gather
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
    hotness: tuple[int, ...] = ()  # per slot, the ids of its bag (empty: one each)

    @property
    def alloc_rows(self) -> int:
        return -(-self.total_rows // ALLOC_MULTIPLE) * ALLOC_MULTIPLE

    @property
    def multi_hot(self) -> bool:
        """Whether a slot of the group holds a bag of more than one id."""
        return any(h > 1 for h in self.hotness)


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
                hotness=tuple(schema.slots[s].hotness for s in slots),
            )
        )
    return tuple(groups)


class EmbeddingCollection:
    """Stateless descriptor + functional ops over ``{group.name: table}``."""

    def __init__(self, schema: Schema):
        self.schema = schema
        self.groups = build_groups(schema)
        self.max_dim = schema.max_dim
        # each group's id columns (its slots' columns, slot-major) and the
        # row offset of each; one column a slot when every hotness is 1
        first = np.cumsum([0, *schema.hotness])
        self._columns = {
            g.name: tuple(c for s in g.slot_indices for c in range(first[s], first[s + 1]))
            for g in self.groups
        }
        self._np_offsets = {
            g.name: np.repeat(np.asarray(g.row_offsets, dtype=np.int32), g.hotness) for g in self.groups
        }
        self._offsets: dict = {}  # (group, device) -> offsets tensor

    def init(self, generator: torch.Generator, device) -> Dict[str, torch.Tensor]:
        """Dim-1 groups start at zero, stored 1-D ``[rows]``; vector groups
        N(0, 0.05) ``[rows, dim]``, all f32 on ``device``."""
        params = {}
        for g in self.groups:
            s = 0.0 if g.dim == 1 else 0.05
            shape = (g.alloc_rows,) if g.dim == 1 else (g.alloc_rows, g.dim)
            # scaled in place (the same bits as ``* s``): a 26.6 GB table
            # leaves no room on the card for a scaled copy beside it
            params[g.name] = torch.randn(
                shape, generator=generator, device=device, dtype=torch.float32
            ).mul_(s)
        return params

    def param_shapes(self) -> Dict[str, tuple]:
        """Each group's table shape: ``(alloc_rows,)`` for dim 1, else
        ``(alloc_rows, dim)``."""
        return {g.name: ((g.alloc_rows,) if g.dim == 1 else (g.alloc_rows, g.dim)) for g in self.groups}

    def group_row_ids(self, ids: torch.Tensor) -> Dict[str, torch.Tensor]:
        """[B, n_ids] slot-local int32 ids (``n_ids == n_slots`` for one-hot
        slots) -> per-group global row ids [B, n_g] int32 (a multi-hot
        group: [B, its id columns]).

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
            columns = self._columns[g.name]
            if columns == tuple(range(ids.shape[1])):
                cols = ids
            else:
                cols = ids[:, list(columns)]
            out[g.name] = cols + self._offsets[key][None, :]
        return out

    def gather_rows(self, params: Dict[str, torch.Tensor], gids: Dict[str, torch.Tensor],
                    dtype: torch.dtype | None = None) -> Dict[str, torch.Tensor]:
        """Per-group gather: {g: [B, n_g]} global row ids -> {g: [B, n_g,
        dim]} in ``dtype`` (default the tables', f32), through the row
        gather (``embedding/gather.py``: the kernel for CUDA tables, its
        plain version for CPU ones), or a multi-hot group's bags through
        the pooled bag gather (``embedding/bag.py``); dim-1 tables gather
        as one column."""
        out = {}
        for g in self.groups:
            t = params[g.name]
            out[g.name] = gather_group(t, g, gids[g.name], dtype or t.dtype)
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
        """Inference-path lookup: [B, n_ids] slot-local ids -> [B, n_slots,
        max_dim]."""
        return self.combine(self.gather_rows(params, self.group_row_ids(ids)))

    def nbytes(self) -> int:
        """The tables' logical bytes (f32 rows of every slot's vocab)."""
        return sum(g.total_rows * g.dim * 4 for g in self.groups)


def gather_group(table: torch.Tensor, group: DimGroup, gids: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """One group's rows [B, n_g, dim] in ``dtype`` from its global row ids:
    the row gather, or the bag gather where the group is multi-hot."""
    t = table.reshape(table.shape[0], -1)
    if group.multi_hot:
        return bag_gather(t, gids, group.hotness, dtype)
    return gather_rows(t, gids, dtype)
