"""The engine: embedding collections + a model, and the forward pass.

Port of ``recmodels_tpu/train/engine.py`` for serving: ``LocalTables``
(single-device tables and their gather) and ``Engine`` (the wide-column
fusion, ``init`` and ``logits``). The training step, its optimizers and the
sharded tables come with later slices of the port.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple

import torch

from recmodels_tpu_torch.data.schema import Schema
from recmodels_tpu_torch.embedding.collection import EmbeddingCollection
from recmodels_tpu_torch.embedding.gather import gather_rows
from recmodels_tpu_torch.models.base import CTRModel


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises for CUDA when no card is
    present, so a missing GPU never turns into a silent CPU run."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain PyTorch path"
        )
    return device


class TrainState(NamedTuple):
    """Parameters of a model on one device. The optimizer states of the JAX
    ``TrainState`` come with the training slice."""

    step: int
    dense_params: Any
    emb_params: Dict[str, Dict[str, torch.Tensor]]  # {collection: {group: table}}


class LocalTables:
    """Single-device tables: plain row-major f32 ``[rows, dim]`` (dim-1
    groups ``[rows]``), gathered in batch order by ``gather_rows``."""

    def __init__(self, collections: Dict[str, EmbeddingCollection]):
        self.collections = collections

    def init_params(self, generator: torch.Generator, device) -> Dict[str, Dict[str, torch.Tensor]]:
        return {name: coll.init(generator, device) for name, coll in self.collections.items()}

    def gather(self, emb_params, gids, dtype) -> Dict[str, Dict[str, torch.Tensor]]:
        """{coll: {group: [B, n_g]}} -> {coll: {group: [B, n_g, dim]}} in
        ``dtype``."""
        out = {}
        for name, coll in self.collections.items():
            res = {}
            for g in coll.groups:
                t = emb_params[name][g.name]
                res[g.name] = gather_rows(t.reshape(t.shape[0], -1), gids[name][g.name], dtype)
            out[name] = res
        return out


@dataclasses.dataclass
class Engine:
    """Wires a model and its embedding collections into the forward pass.

    Models that want both a dim-1 'wide' collection and a uniform-dim 'emb'
    collection over the same vocab layout get one table of dim D+1 whose
    last column is the first-order weight (the JAX package's default layout,
    and its artifacts')."""

    model: CTRModel

    def __post_init__(self):
        # f32 products (dense @ w_dense, p @ w_cin, the widened MLP) stay
        # full f32 on the card, as on the CPU and in the JAX package
        torch.backends.cuda.matmul.allow_tf32 = False
        schemas = self.model.embedding_schemas()
        self._fused_wide = (
            set(schemas) >= {"wide", "emb"}
            and schemas["emb"].uniform_dim
            and schemas["wide"].vocab_sizes == schemas["emb"].vocab_sizes
            and all(s.embed_dim == 1 for s in schemas["wide"].slots)
        )
        if self._fused_wide:
            emb_sch = schemas["emb"]
            self._emb_dim = emb_sch.max_dim
            fused = Schema(
                n_dense=emb_sch.n_dense,
                slots=tuple(dataclasses.replace(s, embed_dim=s.embed_dim + 1) for s in emb_sch.slots),
            )
            coll_schemas = {"emb": fused}
            coll_schemas.update({k: v for k, v in schemas.items() if k not in ("wide", "emb")})
        else:
            coll_schemas = schemas
        self.collections = {name: EmbeddingCollection(sch) for name, sch in coll_schemas.items()}
        self.tables = LocalTables(self.collections)
        # rows are gathered in the compute dtype (bf16 models: bf16 rows)
        self._gather_dtype = getattr(self.model, "compute_dtype", torch.float32)

    def init(self, seed: int = 0, device="cuda") -> TrainState:
        """Fresh parameters on ``device``, drawn from a ``torch.Generator``
        seeded with ``seed``."""
        device = resolve_device(device)
        gen = torch.Generator(device=device).manual_seed(seed)
        dense_params = self.model.init_dense(gen, device)
        emb_params = self.tables.init_params(gen, device)
        if self._fused_wide:
            for t in emb_params["emb"].values():
                t[:, -1] = 0.0  # the fused wide column starts at zero
        return TrainState(step=0, dense_params=dense_params, emb_params=emb_params)

    def _group_ids(self, ids: torch.Tensor):
        """Per-collection global row ids; collections with identical groups
        share one tensor."""
        cache: dict = {}
        out = {}
        for name, coll in self.collections.items():
            per_group = {}
            for g in coll.groups:
                key = (g.slot_indices, g.row_offsets)
                if key not in cache:
                    cache[key] = coll.group_row_ids(ids)[g.name]
                per_group[g.name] = cache[key]
            out[name] = per_group
        return out

    def _forward_from_rows(self, dense_params, rows, dense):
        emb = {name: coll.combine(rows[name]) for name, coll in self.collections.items()}
        if self._fused_wide:
            full = emb.pop("emb")  # [B, slots, D+1]
            if hasattr(self.model, "apply_fused_rows"):
                return self.model.apply_fused_rows(dense_params, dense, full)
            emb["emb"] = full[..., : self._emb_dim]
            emb["wide"] = full[..., self._emb_dim:]
        if "wide" in emb:
            # first-order sums stay f32 even when rows are gathered bf16
            emb["wide"] = emb["wide"].float()
        return self.model.apply(dense_params, dense, emb)

    def logits(self, state: TrainState, dense: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        """Inference forward: dense [B, n_dense] f32, ids [B, n_slots] int32
        slot-local, on the parameters' device -> logits [B] f32."""
        gids = self._group_ids(ids)
        rows = self.tables.gather(state.emb_params, gids, self._gather_dtype)
        out = self._forward_from_rows(state.dense_params, rows, dense)
        # a (B, 1) term broadcast against [B] terms would build (B, B) logits
        assert out.shape == (dense.shape[0],), out.shape
        return out
