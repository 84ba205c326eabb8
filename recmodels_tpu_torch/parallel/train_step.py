"""The data-parallel steps over a mesh (port of
``recmodels_tpu/parallel/train_step.py``).

JAX runs ``Engine.train_step`` under ``shard_map``: the batch split over the
``data`` axis, the dense parameters replicated, the tables and their
optimizer state split by rows. Here every rank of the mesh runs the same
engine on its own block of the batch, and the engine's collectives
(``Engine._reduce``, the exchange of ``ShardedTables``) tie the ranks
together.

Batches: every step here takes the GLOBAL batch, the same on every rank, and
runs on this rank's contiguous block of it, rows ``[r*B/d, (r+1)*B/d)``, as
``PartitionSpec('data')`` splits it (the batch axis of a stacked ``[K, B,
...]`` scan or ``[A, Bm, ...]`` accumulated batch). B must divide by d.

The per-rank form, the counterpart of ``jax.make_array_from_process_local_data``
(where each process reads its own shard of the input, as the Trainer does):
the engine's own steps, ``engine.jit_train_step()``, ``jit_train_scan()``,
``jit_train_step_accum()``, ``jit_train_scan_accum()`` and
``jit_eval_step()`` of a ``build_parallel_engine`` engine, take this rank's
block itself (``[B, ...]``, ``[K, B, ...]``, ``[A, Bm, ...]``); the global
batch is the ranks' blocks in rank order, and nothing gathers it. The
``build_parallel_*`` functions below narrow a global batch to that block
and call those steps (``build_parallel_steps``' ``.captured``).

On an NCCL mesh the steps are the engine's CUDA graphs
(``Engine.jit_train_step`` and its kin, ``train/capture.py``), the
counterpart of ``jax.jit``: NCCL's ``all_to_all_single`` and
``all_reduce`` are captured into the graph and replayed with it. On a gloo
mesh the same callables run the steps without capture, eagerly.
"""

from __future__ import annotations

import torch.distributed as dist

from recmodels_tpu_torch.parallel.mesh import DATA_AXIS, Mesh
from recmodels_tpu_torch.parallel.sharded_embedding import ShardedTables
from recmodels_tpu_torch.train.engine import Engine, TrainState

REPLICATED = "replicated"  # every rank holds the whole tensor (``PartitionSpec()``)
ROWS = DATA_AXIS  # split by rows over the data axis (``PartitionSpec('data')``)


def build_parallel_engine(model, mesh: Mesh, dense_optimizer: str = "adam", sparse_optimizer: str = "adagrad",
                          dense_lr: float = 1e-3, emb_lr: float = 1e-2, capacity_factor: float = 1.25,
                          **kwargs) -> Engine:
    """An engine for ``mesh``: data-parallel over it, tables row-sharded
    over it (``ShardedTables``)."""

    def factory(collections, sparse_opt):
        return ShardedTables(collections, sparse_opt, mesh, capacity_factor=capacity_factor)

    return Engine(model, dense_optimizer=dense_optimizer, sparse_optimizer=sparse_optimizer, dense_lr=dense_lr,
                  emb_lr=emb_lr, table_strategy=factory, **kwargs)


def state_specs(state: TrainState) -> TrainState:
    """Each leaf's layout over the mesh: the step, the dense parameters and
    their optimizer state ``REPLICATED``; the tables and their sparse
    optimizer state ``ROWS``."""

    def spec(tree, s):
        if isinstance(tree, dict):
            return {k: spec(v, s) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(spec(v, s) for v in tree)
        return s

    return TrainState(step=REPLICATED, dense_params=spec(state.dense_params, REPLICATED),
                      emb_params=spec(state.emb_params, ROWS), dense_opt=spec(state.dense_opt, REPLICATED),
                      emb_opt=spec(state.emb_opt, ROWS))


def _place(tree, spec, mesh: Mesh, what: str):
    """A copy of ``tree`` holding this rank's part of each leaf."""
    if isinstance(tree, dict):
        return {k: _place(v, spec[k], mesh, f"{what}/{k}") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_place(v, s, mesh, f"{what}/{i}") for i, (v, s) in enumerate(zip(tree, spec)))
    if tree is None:
        return None
    mesh.require(what, tree)
    if spec == REPLICATED:
        return tree.clone()
    rows = tree.shape[0]
    if rows % mesh.size:
        raise ValueError(f"shard_state: {what} has {rows} rows, which {mesh.size} ranks do not split evenly")
    per = rows // mesh.size
    return tree[mesh.rank * per:(mesh.rank + 1) * per].clone()


def shard_state(state: TrainState, mesh: Mesh) -> TrainState:
    """This rank's part of a GLOBAL state (``Engine.init`` of a sharded
    engine, or ``serve.train_state_from_jax``): rows ``[r*R, (r+1)*R)`` of
    every padded table and its sparse optimizer state, and a copy of every
    replicated tensor, so that the result shares no memory with ``state``.
    Every tensor must lie on the mesh's device."""
    specs = state_specs(state)
    return TrainState(*(_place(getattr(state, f), getattr(specs, f), mesh, f) for f in TrainState._fields))


def gather_state(state: TrainState, mesh: Mesh) -> TrainState | None:
    """The inverse of ``shard_state``: the GLOBAL padded state on the
    mesh's rank 0, None on every other rank. Each row-sharded tensor (the tables
    and their sparse optimizer state) is gathered from every rank's block
    into one new tensor on the mesh's device, one tensor at a time, so the
    peak is one global table beside the state; the replicated tensors are
    this rank's own (shared with ``state``, not copied). A field left None
    (a serving state's optimizers) stays None. A collective: every rank
    calls it together, between steps and outside any graph capture
    (NCCL and gloo)."""
    specs = state_specs(state)
    mine = mesh.rank == 0
    root = 0 if mesh.group is None else dist.get_global_rank(mesh.group, 0)

    def gather(tree, spec, what):
        if isinstance(tree, dict):
            return {k: gather(v, spec[k], f"{what}/{k}") for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(gather(v, s, f"{what}/{i}") for i, (v, s) in enumerate(zip(tree, spec)))
        if tree is None or spec == REPLICATED:
            return tree
        mesh.require(what, tree)
        block = tree.contiguous()
        if mesh.size == 1:
            return block.clone()
        out = block.new_empty((mesh.size * block.shape[0], *block.shape[1:])) if mine else None
        # the gather writes each rank's block straight into its rows of out
        dist.gather(block, list(out.chunk(mesh.size)) if mine else None, dst=root, group=mesh.group)
        return out

    out = TrainState(*(gather(getattr(state, f), getattr(specs, f), f) for f in TrainState._fields))
    return out if mine else None


def _local(t, axis: int, mesh: Mesh):
    """This rank's block of ``t`` along its batch axis."""
    mesh.require("batch", t)
    b = t.shape[axis]
    if b % mesh.size:
        raise ValueError(f"a batch of {b} does not split over {mesh.size} ranks")
    per = b // mesh.size
    return t.narrow(axis, mesh.rank * per, per)


def _check(engine: Engine, mesh: Mesh) -> None:
    if engine.mesh is not mesh:
        raise ValueError("the engine was built for another mesh (build_parallel_engine)")


def build_parallel_steps(engine: Engine, mesh: Mesh):
    """(train_step, eval_step) over the mesh.

    ``train_step(state, dense [B, n_dense], ids [B, n_slots], labels [B])``
    with the global batch and this rank's state (``shard_state``); returns
    (state, {'loss': the mean over the whole batch, 'overflow': the dropped
    lookups of all ranks, a 0-d int32 tensor}), the same on every rank.
    ``eval_step(state, auc_state, dense, ids, labels, weight=None)`` adds
    the whole batch into ``auc_state``. Both are collectives: every rank
    calls them together."""
    _check(engine, mesh)
    ts, es = engine.jit_train_step(), engine.jit_eval_step()

    def train_step(state: TrainState, dense, ids, labels):
        return ts(state, *(_local(t, 0, mesh) for t in (dense, ids, labels)))

    def eval_step(state: TrainState, auc_state, dense, ids, labels, weight=None):
        batch = (dense, ids, labels) if weight is None else (dense, ids, labels, weight)
        return es(state, auc_state, *(_local(t, 0, mesh) for t in batch))

    train_step.captured, eval_step.captured = ts, es
    return train_step, eval_step


def build_parallel_scan(engine: Engine, mesh: Mesh):
    """K steps a call: batches stacked ``[K, B, ...]``, B split over the
    mesh. Returns (state, {'loss': the last, 'losses': [K], 'overflow':
    the largest step's})."""
    _check(engine, mesh)
    scan = engine.jit_train_scan()

    def train_scan(state: TrainState, dense, ids, labels):
        return scan(state, *(_local(t, 1, mesh) for t in (dense, ids, labels)))

    return train_scan


def build_parallel_accum(engine: Engine, mesh: Mesh, scan: bool = False):
    """The gradient-accumulated step over the mesh: the micro-batch axis A
    whole on every rank, each micro-batch Bm split. ``scan=False``: batches
    ``[A, Bm, ...]``; ``scan=True``: ``[K, A, Bm, ...]``."""
    _check(engine, mesh)
    inner = engine.jit_train_scan_accum() if scan else engine.jit_train_step_accum()
    axis = 2 if scan else 1

    def step(state: TrainState, dense, ids, labels):
        return inner(state, *(_local(t, axis, mesh) for t in (dense, ids, labels)))

    return step
