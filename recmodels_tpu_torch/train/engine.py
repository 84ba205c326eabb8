"""The engine: embedding collections + a model + both optimizers.

Port of ``recmodels_tpu/train/engine.py`` for one device: ``LocalTables``
(single-device tables, their gather and their sparse update: Adagrad, lazy
Adam or dense Adam) and ``Engine`` (the wide-column fusion, ``fuse_wide``,
``init``, ``logits``, ``train_step``, ``train_scan`` and ``eval_step``). As
in the JAX package, the loss is differentiated with respect to the gathered
rows (O(batch) memory), and the sparse optimizer applies the row grads to
the touched rows only (dense Adam: to every row).

State is updated in place: ``train_step`` changes the tensors of the state
it is given (the table and its accumulator alone are 354 MB at full width),
its 0-d int32 ``step`` included, and returns that state, as the JAX engine
donates its state; ``eval_step`` adds a batch into the tensors of the
``AUCState`` it is given (``train/metrics.py``). ``jit_train_step``,
``jit_train_scan`` and ``jit_eval_step``, named after their JAX
counterparts, run the same steps as one CUDA graph per batch shape
(``train/capture.py``). Gradient accumulation, schedules, weight decay,
in-graph data generation and the sharded tables (with the cross-device
merge of ``eval_step``'s histograms) come with later slices.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple

import torch
import torch.nn.functional as F

from recmodels_tpu_torch.data.schema import Schema
from recmodels_tpu_torch.embedding.collection import EmbeddingCollection
from recmodels_tpu_torch.embedding.gather import gather_rows
from recmodels_tpu_torch.embedding.optim import (
    SparseOptimizer, apply_updates, get_sparse_optimizer, needs_sort, slot_sorted_ids,
)
from recmodels_tpu_torch.embedding.update import device_constant
from recmodels_tpu_torch.models.base import CTRModel
from recmodels_tpu_torch.train.capture import CapturedEval, CapturedStep
from recmodels_tpu_torch.train.metrics import AUCState, auc_update
from recmodels_tpu_torch.train.optim import get_dense_optimizer
from recmodels_tpu_torch.utils import tree


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
    """Parameters and optimizer states of a model on one device. A serving
    state leaves ``dense_opt`` and ``emb_opt`` None."""

    step: torch.Tensor  # 0-d int32 on the state's device, advanced in place
    dense_params: Any
    emb_params: Dict[str, Dict[str, torch.Tensor]]  # {collection: {group: table}}
    dense_opt: Any = None  # the dense optimizer's state (train/optim.py)
    emb_opt: Dict[str, Dict[str, Any]] | None = None  # {collection: {group: state}}


class LocalTables:
    """Single-device tables: plain row-major f32 ``[rows, dim]`` (dim-1
    groups ``[rows]``), gathered in batch order by ``gather_rows`` and
    updated in place by the sparse optimizer."""

    def __init__(self, collections: Dict[str, EmbeddingCollection],
                 sparse_opt: SparseOptimizer | None = None):
        self.collections = collections
        self.sparse_opt = sparse_opt

    def init_params(self, generator: torch.Generator, device) -> Dict[str, Dict[str, torch.Tensor]]:
        return {name: coll.init(generator, device) for name, coll in self.collections.items()}

    def init_opt(self, params) -> Dict[str, Dict[str, Any]]:
        """The sparse optimizer's state per group, on the tables' device."""
        return {
            name: {
                g.name: self.sparse_opt.init(g.alloc_rows, g.dim, params[name][g.name].device)
                for g in coll.groups
            }
            for name, coll in self.collections.items()
        }

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

    def apply_grads(self, emb_params, emb_opt, gids, grad_rows, step, lr):
        """Apply the row grads {coll: {group: [B, n_g, dim]}} to the tables
        and their optimizer states, in place; returns both. ``step`` is the
        global step before this update (Adam's bias corrections), a 0-d
        int32 tensor, and ``lr`` a 0-d f32 tensor, on the tables' device.
        Groups that share one ids tensor (``Engine._group_ids``) share its
        sort, as JAX's CSE shares it."""
        sorts = []  # (ids tensor, its slot_sorted_ids)
        for name, coll in self.collections.items():
            for g in coll.groups:
                ids_2d = gids[name][g.name]
                stream = None
                if needs_sort(self.sparse_opt):
                    stream = next((st for t, st in sorts if t is ids_2d), None)
                    if stream is None:
                        stream = slot_sorted_ids(ids_2d)
                        sorts.append((ids_2d, stream))
                gr = grad_rows[name][g.name]
                # dim-1 tables are 1-D [rows]; their grads flatten to [N]
                gr_flat = gr.reshape(-1) if g.dim == 1 else gr.reshape(-1, g.dim)
                apply_updates(self.sparse_opt, emb_params[name][g.name], emb_opt[name][g.name],
                              ids_2d, gr_flat, step, lr, stream)
        return emb_params, emb_opt


@dataclasses.dataclass
class Engine:
    """Wires a model, its embedding collections and both optimizers into
    the forward pass and the training step.

    Models that want both a dim-1 'wide' collection and a uniform-dim 'emb'
    collection over the same vocab layout get one table of dim D+1 whose
    last column is the first-order weight (the JAX package's default layout,
    and its artifacts'), unless ``fuse_wide`` is False: then the wide
    column keeps its own dim-1 table and the model runs ``apply``."""

    model: CTRModel
    dense_optimizer: str = "adam"
    sparse_optimizer: str = "adagrad"
    dense_lr: float = 1e-3
    emb_lr: float = 1e-2
    fuse_wide: bool = True

    def __post_init__(self):
        # f32 products (dense @ w_dense, p @ w_cin, the widened MLP) stay
        # full f32 on the card, as on the CPU and in the JAX package; bf16
        # products (AFM's attention) sum in f32 there too, where cuBLAS
        # would otherwise be free to split a long reduction (AFM's 325
        # pairs) into bf16 partial sums
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
        schemas = self.model.embedding_schemas()
        self._fused_wide = (
            self.fuse_wide
            and set(schemas) >= {"wide", "emb"}
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
        self.dense_tx = get_dense_optimizer(self.dense_optimizer)
        self.sparse_opt = get_sparse_optimizer(self.sparse_optimizer)
        self.tables = LocalTables(self.collections, self.sparse_opt)
        # rows are gathered in the compute dtype (bf16 models: bf16 rows)
        self._gather_dtype = getattr(self.model, "compute_dtype", torch.float32)

    def init(self, seed: int = 0, device="cuda") -> TrainState:
        """Fresh parameters and optimizer states on ``device``, the
        parameters drawn from a ``torch.Generator`` seeded with ``seed``."""
        device = resolve_device(device)
        gen = torch.Generator(device=device).manual_seed(seed)
        dense_params = self.model.init_dense(gen, device)
        emb_params = self.tables.init_params(gen, device)
        if self._fused_wide:
            for t in emb_params["emb"].values():
                t[:, -1] = 0.0  # the fused wide column starts at zero
        return TrainState(
            step=torch.zeros((), dtype=torch.int32, device=device),
            dense_params=dense_params, emb_params=emb_params,
            dense_opt=self.dense_tx.init(list(tree.leaves(dense_params))),
            emb_opt=self.tables.init_opt(emb_params),
        )

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

    # --------------------------------------------------------------- train
    def train_step(self, state: TrainState, dense: torch.Tensor, ids: torch.Tensor,
                   labels: torch.Tensor):
        """One optimizer step on a batch (dense [B, n_dense] f32, ids [B,
        n_slots] int32 slot-local, labels [B] f32, on the state's device).
        Updates the state's tensors in place, its step included, and returns
        (state, {'loss': mean BCE, a 0-d tensor; 'overflow': 0, as local
        tables drop no lookups})."""
        gids = self._group_ids(ids)
        with torch.no_grad():
            gathered = self.tables.gather(state.emb_params, gids, self._gather_dtype)
        # the rows are leaves of their own: the tables change in place below
        rows = {c: {g: t.detach().requires_grad_(True) for g, t in r.items()}
                for c, r in gathered.items()}
        params = list(tree.leaves(state.dense_params))
        live = [p.detach().requires_grad_(True) for p in params]
        row_leaves = [t for r in rows.values() for t in r.values()]
        with torch.enable_grad():
            logits = self._forward_from_rows(tree.unflatten(state.dense_params, iter(live)),
                                             rows, dense)
            # a (B, 1) term broadcast against [B] terms would build (B, B) logits
            assert logits.shape == labels.shape, (logits.shape, labels.shape)
            loss = F.binary_cross_entropy_with_logits(logits, labels)
            grads = torch.autograd.grad(loss, live + row_leaves)
        g_dense, g_rows_flat = grads[: len(live)], iter(grads[len(live):])
        g_rows = {c: {g: next(g_rows_flat) for g in r} for c, r in rows.items()}
        with torch.no_grad():
            self.dense_tx.update(params, list(g_dense), state.dense_opt, self.dense_lr)
            self.tables.apply_grads(state.emb_params, state.emb_opt, gids, g_rows, state.step,
                                    device_constant(self.emb_lr, state.step.device))
            state.step.add_(1)
        return state, {"loss": loss.detach(), "overflow": 0}

    def train_scan(self, state: TrainState, dense: torch.Tensor, ids: torch.Tensor,
                   labels: torch.Tensor):
        """K steps on batches stacked [K, B, ...]: a loop over
        ``train_step``. Returns (state, {'loss': the last loss, 'losses':
        [K], 'overflow': 0})."""
        losses = []
        for k in range(dense.shape[0]):
            state, metrics = self.train_step(state, dense[k], ids[k], labels[k])
            losses.append(metrics["loss"])
        losses = torch.stack(losses)
        return state, {"loss": losses[-1], "losses": losses, "overflow": 0}

    # ---------------------------------------------------------------- eval
    def eval_step(self, state: TrainState, auc_state: AUCState, dense: torch.Tensor,
                  ids: torch.Tensor, labels: torch.Tensor,
                  weight: torch.Tensor | None = None) -> AUCState:
        """Score a batch and add it to ``auc_state`` in place (its
        histograms, loss sum and count; ``weight`` a [B] 0/1 mask for padded
        tail rows); returns ``auc_state``. Inputs as for ``train_step``, the
        AUC state on the same device."""
        with torch.no_grad():
            return auc_update(auc_state, self.logits(state, dense, ids), labels, weight)

    # ------------------------------------------------------------- capture
    def jit_train_step(self) -> CapturedStep:
        """``train_step`` as one CUDA graph per batch shape: a callable with
        ``train_step``'s signature and results (``train/capture.py``). On a
        CUDA state its first call for a shape runs the step eagerly, its
        second captures the step and replays it, and later calls replay; a
        state with other tensors captures again. On a CPU state it runs the
        same static-buffer code without capture."""
        return CapturedStep(lambda state, *batch: self.train_step(state, *batch)[1]["loss"])

    def jit_train_scan(self):
        """``train_scan`` over ``jit_train_step``'s graph: K replays, batch k
        copied in before replay k and loss k written into a [K] buffer on
        the state's device. Returns (state, {'loss', 'losses', 'overflow'})
        as ``train_scan``."""
        steps = self.jit_train_step()

        def train_scan(state: TrainState, dense: torch.Tensor, ids: torch.Tensor,
                       labels: torch.Tensor):
            losses = torch.empty((dense.shape[0],), dtype=torch.float32, device=state.step.device)
            for k in range(dense.shape[0]):
                losses[k].copy_(steps.step(state, (dense[k], ids[k], labels[k])))
            return state, {"loss": losses[-1], "losses": losses, "overflow": 0}

        return train_scan

    def jit_eval_step(self) -> CapturedEval:
        """``eval_step`` as one CUDA graph per batch shape (a batch with
        ``weight`` is a shape of its own), captured and replayed as
        ``jit_train_step``'s: a callable with ``eval_step``'s signature that
        adds each batch into the tensors of the ``AUCState`` it is given and
        returns it. A graph belongs to one train state and one AUC state
        (their tensors' addresses); others capture again. On a CPU state it
        runs the same static-buffer code without capture."""
        return CapturedEval(lambda states, *batch: self.eval_step(*states, *batch).count)
