"""The benchmark's door into the program for a configuration of multi-hot
pooled bags (DLRM-DCNv2): build its engine from the configuration, write the
benchmark's weights into its state, and read from its state what the check
compares. ``port.py`` is the door of the one-hot configurations, whose
table has a fused first-order column and one vocab a slot; this table has
per-slot rows, dim 128 and no such column, and both optimizers are Adagrad.

The program's parameter layouts are the reference's (``[in, out]``, the
flatten names ``bottom.k.w``, ``cross.k.v``, ...), so weights cross as
they are.
"""

from __future__ import annotations

import torch

from benchmark.gen import multihot as W
from benchmark.port import EPS_ADAGRAD, acc_of, dense_leaves, table_of

DENSE_EPS = 1e-7  # the program's dense Adagrad (optax's eps)


def build_engine(cfg: dict):
    from recmodels_tpu_torch.data.schema import criteo_schema
    from recmodels_tpu_torch.models import build_model
    from recmodels_tpu_torch.train.engine import Engine

    schema = criteo_schema(vocab_size=list(cfg["num_embeddings_per_feature"]), embed_dim=cfg["embed_dim"],
                           hotness=list(cfg["hotness"]))
    model = build_model(cfg["model"], schema, bottom=tuple(cfg["bottom"]), top=tuple(cfg["top"]),
                        n_cross=cfg["n_cross"], low_rank=cfg["low_rank"],
                        compute_dtype=getattr(torch, cfg["compute_dtype"]))
    return Engine(model, dense_optimizer=cfg["dense_optimizer"], sparse_optimizer=cfg["sparse_optimizer"],
                  dense_lr=cfg["dense_lr"], emb_lr=cfg["emb_lr"])


@torch.no_grad()
def write_weights(state, cfg: dict, seed: int) -> None:
    """The benchmark's weights for ``seed`` into the program's state, in
    place."""
    W.fill_table(table_of(state), cfg, seed)
    ref = W.dense_weights(cfg, seed, table_of(state).device)
    prog = dense_leaves(state)
    if set(prog) != set(ref):
        raise ValueError(f"the program's parameters {sorted(prog)} are not the reference's {sorted(ref)}")
    for name, t in prog.items():
        t.copy_(ref[name])


def train_state(engine, cfg: dict, seed: int, device):
    state = engine.init(seed=0, device=device)
    write_weights(state, cfg, seed)
    return state


def with_wide(rows: torch.Tensor) -> torch.Tensor:
    """Rows [n, D] with a zero first-order column, the form of the
    check's table gradient (``check.table_errors``: the last column is
    ``table.wide``, 0 on both sides here)."""
    return torch.cat([rows, rows.new_zeros((rows.shape[0], 1))], dim=1)


class StepProbe:
    """What the check reads of the program's first steps, from its state:

    * after step 1, each leaf's first gradient as the optimizer got it: a
      dense leaf's from dense Adagrad's move ``p1 - p0 = -lr g / sqrt(s1 +
      eps)``, the table's from per-element Adagrad's ``w1 - w0 = -lr g /
      (sqrt(acc1) + eps)``, so ``g`` is the move times the root over ``lr``
      (``s1`` and ``acc1`` alone cannot resolve a gradient whose square is
      under an ulp of their initial 0.1); the table's as (moved rows'
      global ids, their gradient with a zero first-order column);
    * after step 3, before step 4, the norm of each leaf's change since the
      start.

    The initial table is made again block by block from the seed
    (``multihot.table_block``), so no copy of it is held."""

    def __init__(self, state, cfg: dict, seed: int):
        self.cfg, self.seed = cfg, seed
        self.start = {k: v.detach().clone() for k, v in dense_leaves(state).items()}
        self.grad = self.grad_vec = self.grad_table = self.change = None

    def _table_sums(self, table: torch.Tensor, fn, keep=None) -> dict:
        """The norm of ``fn``'s rows over the table, block by block; ``keep(
        first_row, x)`` sees each block's."""
        total = torch.zeros((), dtype=torch.float64, device=table.device)
        for s, k, first, rows in W.blocks(self.cfg):
            x = fn(first, rows, table[first:first + rows], W.table_block(self.cfg, self.seed, s, k, table.device))
            total = total + (x.double() ** 2).sum()
            if keep is not None:
                keep(first, x)
        tail = table[W.n_rows(self.cfg):]  # rows no slot owns: they must stay 0
        total = total + (tail.double() ** 2).sum()
        if keep is not None:
            keep(W.n_rows(self.cfg), tail)
        return {"table.emb": float(total.sqrt()), "table.wide": 0.0}

    @torch.no_grad()
    def after_first(self, state) -> None:
        table, acc, lr = table_of(state), acc_of(state), self.cfg["emb_lr"]
        ids, rows = [], []

        def keep(first_row: int, g: torch.Tensor) -> None:
            moved = torch.nonzero(g.ne(0).any(dim=1)).flatten()
            ids.append(moved + first_row)
            rows.append(with_wide(g[moved].float()))

        grads = self._table_sums(
            table, lambda first, n, w1, w0: (w0 - w1) * (torch.sqrt(acc[first:first + n]) + EPS_ADAGRAD) / lr, keep)
        self.grad_table = (torch.cat(ids), torch.cat(rows))
        sos = dict(zip(dense_leaves(state), state.dense_opt["sum_of_squares"]))
        now = dense_leaves(state)
        self.grad_vec = {name: (self.start[name] - now[name]) * torch.sqrt(sos[name] + DENSE_EPS) / self.cfg["dense_lr"]
                         for name in now}
        for name, t in self.grad_vec.items():
            grads[name] = float(torch.linalg.vector_norm(t.double()))
        self.grad = grads

    @torch.no_grad()
    def after_third(self, state) -> None:
        change = self._table_sums(table_of(state), lambda first, n, w3, w0: w3 - w0)
        for name, t in dense_leaves(state).items():
            change[name] = float(torch.linalg.vector_norm((t - self.start[name]).double()))
        self.change = change

    def readings(self, losses: list) -> dict:
        return {"loss": losses, "grad": self.grad, "grad_vec": self.grad_vec, "grad_table": self.grad_table,
                "change": self.change}
