"""Row-sharded embedding tables with an all-to-all id exchange (port of
``recmodels_tpu/parallel/sharded_embedding.py``; its docstring has the
design).

Each rank of the mesh owns a contiguous block of every table's rows and of
their optimizer state: rank s owns global rows ``[s*R, (s+1)*R)`` of a
table padded to ``padded_rows``. A lookup is an exchange:

  1. sort this rank's ids of a group into one ascending stream (the
     per-slot sort the local update already pays) and cut it at the shard
     bounds (``searchsorted``): bucket o is the run of ids that rank o owns,
     at most ``cap`` of them; ids past ``cap`` overflow, and the slots of a
     bucket past its count hold the INT32_MAX sentinel;
  2. hop 1, ids to their owner (``all_to_all_single``); the owner takes
     them to local rows, anything outside ``[0, R)`` to the sentinel R;
  3. the owner gathers its rows at those ids with the row-gather kernel
     (``csrc/gather.cu``), the sentinel clamped to row R-1, in the compute
     dtype; hop 2 sends them back;
  4. the requester puts each row where its id came from: position q of the
     batch takes slot ``o*cap + j`` of what came back, where o owns the id
     and j is its place in bucket o; a position whose j is ``cap`` or more
     overflowed and takes a zero row (the JAX package's drop-lookup
     contract).

The gradient path runs the route in reverse: each bucket slot takes the
grad row of its id (one gather), the grads ride to the owner beside the ids
of hop 1, the owner merges the d buckets into one ascending stream (a
stable sort, so equal ids keep the requesters' order and the f32 sums the
order of the JAX package's; at d = 1 the stream arrives sorted and nothing
is merged) and the sorted-stream update (``csrc/adagrad_update.cu``,
``csrc/adam_update.cu``) applies it, skipping the sentinel tail; dense Adam
drops the sentinels in its scatter.

Everything a step needs to route one group is its plan (``plan``): the
sort, the bounds, the bucket maps, hop 1 and the owner's stream, computed
once a step and shared by the gather and the update, and by the groups of
two collections over one ids tensor (``Engine._group_ids``), where the JAX
package relies on XLA's CSE. Every buffer's shape depends only on the
batch, the group's slot count, ``cap`` and the rank count, and no count is
read back to the host: a step captures as a CUDA graph.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple

import torch

from recmodels_tpu_torch.embedding.collection import EmbeddingCollection
from recmodels_tpu_torch.embedding.gather import gather_rows
from recmodels_tpu_torch.embedding.optim import (
    SparseOptimizer, apply_sorted_updates, slot_sorted_ids, slot_sorted_inverse,
)
from recmodels_tpu_torch.parallel.mesh import Mesh

SENTINEL = torch.iinfo(torch.int32).max  # a bucket slot past the bucket's count


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


class GroupPlan(NamedTuple):
    """One group's route for one step (``ShardedTables.plan``): positions
    are int64, ids int32."""

    overflow: torch.Tensor  # 0-d int32: this rank's lookups past a bucket's cap
    send_src: torch.Tensor  # [d*cap] int64: the b-major position whose grad each bucket slot sends
    back_src: torch.Tensor  # [N] int64: the returned slot of each b-major position (clamped)
    back_valid: torch.Tensor  # [N, 1] bool: False where the position overflowed
    gather_ids: torch.Tensor  # [d*cap] int32: the owner's local rows in receive order, sentinel -> R-1
    stream_ids: torch.Tensor  # [d*cap] int32: the owner's ascending stream, sentinel R
    merge: torch.Tensor | None  # [d*cap] int64: receive position of each stream position; None at d = 1


class ShardedTables:
    """Table strategy (``train/engine.py``'s interface) whose tables are split
    by rows over ``mesh``. ``init_params`` and ``init_opt`` make the global
    padded state (``parallel.shard_state`` cuts this rank's block from it);
    ``plan``, ``gather`` and ``apply_grads`` run on this rank's block,
    ``emb_params[coll][group]`` ``[R, dim]`` (``[R]`` for dim 1), and are
    collectives: every rank of the mesh calls them together."""

    def __init__(self, collections: Dict[str, EmbeddingCollection], sparse_opt: SparseOptimizer, mesh: Mesh,
                 capacity_factor: float = 1.25):
        multi = [name for name, coll in collections.items() if coll.schema.multi_hot]
        if multi:
            raise NotImplementedError(
                f"sharded tables take one id a slot; collections {multi} hold multi-hot bags (pooled bags run "
                f"on LocalTables, one device)")
        self.collections = collections
        self.sparse_opt = sparse_opt
        self.mesh = mesh
        self.n_shards = mesh.size
        # every exchange buffer scales with it; hashed ids spread evenly over
        # the shards, so 1.25 leaves wide headroom (the JAX package's default)
        self.capacity_factor = capacity_factor

    # ------------------------------------------------------------ geometry
    def padded_rows(self, coll: str, group) -> int:
        """The global table's rows: a multiple of ``n_shards * 1024``, as in
        the JAX package (whose kernels tile by 1024), so that the shard
        bounds, and with them the overflow counts, are JAX's."""
        unit = self.n_shards * 1024
        return _cdiv(group.alloc_rows, unit) * unit

    def rows_per_shard(self, coll: str, group) -> int:
        return self.padded_rows(coll, group) // self.n_shards

    def table_rows(self, coll: str, group) -> int:
        """The rows of the global state's table (``padded_rows``)."""
        return self.padded_rows(coll, group)

    def _capacity(self, n_flat_ids: int) -> int:
        """Ids a bucket holds: the JAX package's rule (a multiple of 8)."""
        c = _cdiv(int(n_flat_ids * self.capacity_factor), self.n_shards)
        return max(8, _cdiv(c, 8) * 8)

    # ---------------------------------------------------------------- init
    def init_params(self, generator: torch.Generator, device) -> Dict[str, Dict[str, torch.Tensor]]:
        """The global tables, drawn as ``LocalTables`` draws them and padded
        with zero rows to ``padded_rows``."""
        out = {}
        for name, coll in self.collections.items():
            tables = coll.init(generator, device)
            out[name] = {}
            for g in coll.groups:
                t = tables[g.name]
                pad = torch.zeros((self.padded_rows(name, g) - g.alloc_rows, *t.shape[1:]),
                                  dtype=t.dtype, device=t.device)
                out[name][g.name] = torch.cat([t, pad])
        return out

    def init_opt(self, params) -> Dict[str, Dict[str, Any]]:
        """The sparse optimizer's global state per group, on the tables' device."""
        return {
            name: {
                g.name: self.sparse_opt.init(self.padded_rows(name, g), g.dim, params[name][g.name].device)
                for g in coll.groups
            }
            for name, coll in self.collections.items()
        }

    # ------------------------------------------------------------ exchange
    def _plan_group(self, ids_2d: torch.Tensor, rows_per_shard: int) -> GroupPlan:
        """The route of one group's [B, n_g] global row ids; runs hop 1."""
        d, r, big_r = self.n_shards, self.mesh.rank, rows_per_shard
        self.mesh.require("ids", ids_2d)
        n = ids_2d.numel()
        cap = self._capacity(n)
        dev = ids_2d.device
        sorted_ids, order, order_2d = slot_sorted_ids(ids_2d)
        edges = torch.arange(d + 1, dtype=torch.int32, device=dev) * big_r
        bounds = torch.searchsorted(sorted_ids, edges, out_int32=True).long()  # [d+1]
        counts = bounds[1:] - bounds[:-1]
        overflow = (counts - cap).clamp_min(0).sum().to(torch.int32)
        slot = torch.arange(cap, device=dev)
        pos = (bounds[:-1, None] + slot).clamp_max(n - 1)  # [d, cap] sorted positions
        send_ids = torch.where(slot < counts[:, None], sorted_ids[pos], SENTINEL)
        send_src = order.long()[pos].reshape(-1)
        # hop 1: requester -> owner
        local = self.mesh.all_to_all(send_ids).reshape(-1) - r * big_r  # the sentinel stays >= R
        local = torch.where((local >= 0) & (local < big_r), local, big_r)
        if d == 1:  # one bucket: a slice of the sorted stream, sorted already
            stream, merge = local, None
        else:  # stable: equal ids keep the requesters' order
            stream, merge = torch.sort(local, stable=True)
        # readback: sorted position p is in bucket o = id // R at j = p - bounds[o]
        owner = torch.div(sorted_ids, big_r, rounding_mode="floor").long()
        j = torch.arange(n, device=dev) - bounds[owner]
        inv = slot_sorted_inverse(order_2d).long()  # b-major position -> sorted position
        back_src = (owner * cap + j).clamp_max(d * cap - 1)[inv]
        back_valid = (j < cap)[inv][:, None]
        return GroupPlan(overflow=overflow, send_src=send_src, back_src=back_src, back_valid=back_valid,
                         gather_ids=local.clamp_max(big_r - 1), stream_ids=stream, merge=merge)

    def plan(self, gids) -> Dict[str, Dict[str, GroupPlan]]:
        """{coll: {group: [B, n_g] global ids}} -> {coll: {group: GroupPlan}}:
        the step's routes, one per distinct ids tensor (groups of two
        collections over one tensor share it). A collective."""
        plans: list = []  # (ids tensor, rows per shard, its plan)
        out = {}
        for name, coll in self.collections.items():
            out[name] = {}
            for g in coll.groups:
                ids_2d, big_r = gids[name][g.name], self.rows_per_shard(name, g)
                found = next((p for t, rr, p in plans if t is ids_2d and rr == big_r), None)
                if found is None:
                    found = self._plan_group(ids_2d, big_r)
                    plans.append((ids_2d, big_r, found))
                out[name][g.name] = found
        return out

    def _gather_group(self, table: torch.Tensor, p: GroupPlan, shape: tuple, dtype) -> torch.Tensor:
        """The owner's gather, hop 2 and the readback: [B, n_g, dim]."""
        d = self.n_shards
        rows = gather_rows(table.reshape(table.shape[0], -1), p.gather_ids, dtype or table.dtype)
        back = self.mesh.all_to_all(rows.reshape(d, -1, rows.shape[-1])).reshape(-1, rows.shape[-1])
        out = torch.where(p.back_valid, back.index_select(0, p.back_src), 0.0)
        return out.reshape(*shape, rows.shape[-1])

    def gather(self, emb_params, plans, dtype=None, with_stats: bool = False):
        """{coll: {group: [B, n_g, dim]}} in ``dtype`` (default the tables')
        along ``plans`` (``plan``); ``with_stats``: also the total of
        this rank's overflowed lookups over the groups, a 0-d int32 tensor
        (the loop surfaces it instead of training on zero rows). A
        collective."""
        out, overflows = {}, []
        for name, coll in self.collections.items():
            out[name] = {}
            for g in coll.groups:
                p = plans[name][g.name]
                shape = (p.back_src.numel() // len(g.slot_indices), len(g.slot_indices))
                out[name][g.name] = self._gather_group(emb_params[name][g.name], p, shape, dtype)
                overflows.append(p.overflow)  # each group counts its own, as in the JAX package
        return (out, torch.stack(overflows).sum(dtype=torch.int32)) if with_stats else out

    def gather_with_stats(self, emb_params, gids):
        """``gather`` of the groups' [B, n_g] ids with its overflow count."""
        return self.gather(emb_params, self.plan(gids), with_stats=True)

    def apply_grads(self, emb_params, emb_opt, plans, grad_rows, step, lr):
        """Send the row grads {coll: {group: [B, n_g, dim]}} to their
        owners along ``plans`` and apply them to this rank's rows and
        optimizer state, in place; returns both. ``step`` and ``lr`` as for
        ``LocalTables.apply_grads``. A collective."""
        d = self.n_shards
        for name, coll in self.collections.items():
            for g in coll.groups:
                p = plans[name][g.name]
                gr = grad_rows[name][g.name]
                gr = gr.reshape(-1) if g.dim == 1 else gr.reshape(-1, g.dim)
                send = gr.index_select(0, p.send_src)
                recv = self.mesh.all_to_all(send.reshape(d, -1, *send.shape[1:])).reshape(send.shape)
                if p.merge is not None:
                    recv = recv.index_select(0, p.merge)
                apply_sorted_updates(self.sparse_opt, emb_params[name][g.name], emb_opt[name][g.name],
                                     p.stream_ids, recv, step, lr)
        return emb_params, emb_opt
