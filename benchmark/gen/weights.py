"""The weights a run starts from, made by the benchmark from the seed on the
device, and handed alike to the program and to the reference.

Every parameter is live: the tables' wide column, ``w_dense`` and the bias
are drawn like the rest, so that a wrong first-order term or bias shows in
the logits. Names are the reference's (``benchmark/reference/model.py``):

* ``table``: ``[n_slots * V, D + 1]`` f32, slot s's rows at ``s * V``, the
  last column the first-order (wide) weight. Made a slot at a time, each
  slot from a generator of its own, so that any slot's rows can be made
  again later (``table_chunk``) without holding a copy of the table.
* the rest as ``reference/model.py`` names and shapes them (``mlp.k.w``,
  ``mlp.k.b``, ``w_dense``, ``bias`` and the family's own, such as
  xDeepFM's ``cin.k`` and ``w_cin``).
"""

from __future__ import annotations

import torch

from benchmark.gen import zipf
from benchmark.reference import model


def n_rows(cfg: dict) -> int:
    return cfg["n_slots"] * cfg["vocab_size"]


def table_chunk(cfg: dict, seed: int, slot: int, device) -> torch.Tensor:
    """Slot ``slot``'s initial rows ``[V, D + 1]`` f32."""
    out = torch.empty((cfg["vocab_size"], cfg["embed_dim"] + 1), dtype=torch.float32, device=device)
    return out.normal_(0.0, cfg["init_scale"], generator=zipf.generator(seed, device, 3, slot))


def fill_table(table: torch.Tensor, cfg: dict, seed: int) -> None:
    """Write the initial rows into ``table`` (``[rows, D + 1]``, rows at
    least ``n_rows``) in place; rows past ``n_rows`` are zeroed."""
    v = cfg["vocab_size"]
    for s in range(cfg["n_slots"]):
        table[s * v:(s + 1) * v].copy_(table_chunk(cfg, seed, s, table.device))
    table[n_rows(cfg):].zero_()


def initial_rows(cfg: dict, seed: int, gids: torch.Tensor) -> torch.Tensor:
    """The initial rows of the global row ids ``gids`` (sorted, 1-D, int64)
    as ``[n, D + 1]`` f32, made again slot by slot."""
    v = cfg["vocab_size"]
    out = torch.empty((gids.numel(), cfg["embed_dim"] + 1), dtype=torch.float32, device=gids.device)
    for s in range(cfg["n_slots"]):
        sel = (gids >= s * v) & (gids < (s + 1) * v)
        if bool(sel.any()):
            out[sel] = table_chunk(cfg, seed, s, gids.device)[gids[sel] - s * v]
    return out


def dense_weights(cfg: dict, seed: int, device) -> dict:
    """Every parameter but the table, by name, f32 on ``device``: the
    reference's parameters (``reference/model.py``) drawn from the seed."""
    g = zipf.generator(seed, device, 4)

    def randn(*shape, std=1.0):
        return torch.randn(shape, generator=g, device=device, dtype=torch.float32) * std

    return model.init(cfg, randn)
