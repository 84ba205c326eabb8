"""Multi-hot traffic and weights for a configuration of pooled bags (DLRM-DCNv2),
in plain PyTorch, on the card (or on the CPU in the tests).

Each example holds a bag of ``hotness[s]`` ids in slot s, slot-major, as
the program reads them (``[B, n_ids]``):

* the bag's first id is drawn by a Zipf law of exponent ``zipf_exponent``
  over the slot's rows held here (rank k in 1..V with probability
  proportional to k**-s), its ranks scattered over the rows by a seeded
  permutation of the slot, as a hash would;
* each further id is a seeded hash of (slot, first id, position), uniform
  over the slot's rows: MLPerf's synthetic multi-hot expands each one-hot
  value by a fixed set of uniform offsets (``--multi_hot_distribution_type
  uniform``), so a hot first id brings a hot bag.

Dense features and labels are ``zipf.py``'s. Every draw comes from one
``torch.Generator`` seeded from the run's seed (``zipf.generator``), in a few
large calls; the hash is 32-bit integer arithmetic on int64 tensors, exact
on any device.

Weights (``initial_rows``, ``fill_table``, ``dense_weights``): the table is
made slot by slot and, within a slot, by blocks of ``BLOCK`` rows, each from
a generator of its own, so any block can be made again without a copy of
the table (the card holds one table of 26.6 GB); N(0, ``init_scale``). The
rest as ``reference/dlrm_dcnv2.init`` names and draws them.
"""

from __future__ import annotations

import torch

from benchmark.gen import zipf

BLOCK = 1 << 20  # table rows a generator makes
M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2**32`` for x in [0, 2**32) without overflowing int64:
    the constant in 16-bit halves."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & M32


def mix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3's 32-bit finaliser on int64 tensors holding [0, 2**32)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def _salt(seed: int, slot: int, pos: int, k: int) -> int:
    return zipf.derive_seed(seed, 12, slot, pos, k) & M32


class MultiHotSlots:
    """The slots of a cell: ``rows`` a slot (the ids' range), ``hotness`` a
    slot, the Zipf law of the first ids and the seed of the permutations
    and the hash."""

    def __init__(self, rows, hotness, exponent: float, seed: int, device):
        self.rows = [int(r) for r in rows]
        self.hotness = [int(h) for h in hotness]
        if len(self.rows) != len(self.hotness) or min(self.hotness) < 1 or min(self.rows) < 1:
            raise ValueError(f"rows {self.rows} and hotness {self.hotness} do not describe the slots")
        self.exponent = float(exponent)
        self.seed = seed
        self.device = torch.device(device)
        self._cdf = {}
        for v in set(self.rows):
            w = torch.arange(1, v + 1, dtype=torch.float64, device=self.device).pow(-self.exponent)
            cdf = torch.cumsum(w, 0)
            self._cdf[v] = cdf / cdf[-1]
        self.perms = [torch.randperm(v, generator=zipf.generator(seed, self.device, 11, s), device=self.device)
                      .to(torch.int32) for s, v in enumerate(self.rows)]

    @property
    def n_slots(self) -> int:
        return len(self.rows)

    @property
    def n_ids(self) -> int:
        return sum(self.hotness)

    def first_ids(self, n: int, g: torch.Generator) -> torch.Tensor:
        """[n, n_slots] int32: each bag's first id (a Zipf rank through the
        slot's permutation)."""
        u = torch.rand((n, self.n_slots), dtype=torch.float64, generator=g, device=self.device)
        out = torch.empty((n, self.n_slots), dtype=torch.int32, device=self.device)
        for s, v in enumerate(self.rows):
            r = torch.searchsorted(self._cdf[v], u[:, s].contiguous(), right=True).clamp_(max=v - 1)
            out[:, s] = self.perms[s][r]
        return out

    def bags(self, first: torch.Tensor) -> torch.Tensor:
        """[n, n_ids] int32 slot-local ids: slot s's bag is its first id,
        then ``hotness[s] - 1`` hashes of (slot, first id, position)."""
        n = first.shape[0]
        out = torch.empty((n, self.n_ids), dtype=torch.int32, device=self.device)
        c = 0
        for s, (v, h) in enumerate(zip(self.rows, self.hotness)):
            f = first[:, s]
            out[:, c] = f
            x = f.long()
            for j in range(1, h):
                h1 = mix32(x ^ _salt(self.seed, s, j, 0))
                h2 = mix32(h1 ^ _salt(self.seed, s, j, 1))
                out[:, c + j] = (((h1 << 21) | (h2 >> 11)) % v).to(torch.int32)
            c += h
        return out


def slots_for(cfg: dict, params: dict, seed: int, device) -> MultiHotSlots:
    return MultiHotSlots(cfg["num_embeddings_per_feature"], cfg["hotness"], params["zipf_exponent"], seed, device)


def examples(slots: MultiHotSlots, n: int, n_dense: int, params: dict, g: torch.Generator):
    """(dense [n, n_dense] f32 transformed, ids [n, n_ids] int32, labels [n]
    f32) on the slots' device, drawn in ``zipf.examples``' order."""
    dev = slots.device
    first = slots.first_ids(n, g)
    dense = zipf.transform_dense(zipf.dense_counts(n, n_dense, params, g, dev))
    lab = zipf.labels(n, params, g, dev)
    return dense, slots.bags(first), lab


def batch_pool(slots: MultiHotSlots, n_batches: int, batch: int, n_dense: int, params: dict, g: torch.Generator):
    """A pool of batches stacked [n_batches, batch, ...] (dense, ids,
    labels)."""
    dense, ids, lab = examples(slots, n_batches * batch, n_dense, params, g)
    return (dense.reshape(n_batches, batch, n_dense), ids.reshape(n_batches, batch, -1),
            lab.reshape(n_batches, batch))


# ---------------------------------------------------------------- weights
def slot_offsets(cfg: dict) -> list:
    """Each slot's first row in the stacked table, and the end."""
    out = [0]
    for v in cfg["num_embeddings_per_feature"]:
        out.append(out[-1] + int(v))
    return out


def n_rows(cfg: dict) -> int:
    return slot_offsets(cfg)[-1]


def table_block(cfg: dict, seed: int, slot: int, k: int, device) -> torch.Tensor:
    """Rows ``[k * BLOCK, (k + 1) * BLOCK)`` of slot ``slot`` (fewer at the
    slot's end), [rows, D] f32."""
    rows = min(BLOCK, int(cfg["num_embeddings_per_feature"][slot]) - k * BLOCK)
    out = torch.empty((rows, cfg["embed_dim"]), dtype=torch.float32, device=device)
    return out.normal_(0.0, cfg["init_scale"], generator=zipf.generator(seed, device, 3, slot, k))


def blocks(cfg: dict):
    """(slot, block index, first global row, rows) of every block."""
    off = slot_offsets(cfg)
    for s, v in enumerate(cfg["num_embeddings_per_feature"]):
        for k in range(-(-int(v) // BLOCK)):
            yield s, k, off[s] + k * BLOCK, min(BLOCK, int(v) - k * BLOCK)


def fill_table(table: torch.Tensor, cfg: dict, seed: int) -> None:
    """The initial rows into ``table`` [rows >= n_rows, D], in place; rows
    past ``n_rows`` zeroed."""
    for s, k, first, rows in blocks(cfg):
        table[first:first + rows].copy_(table_block(cfg, seed, s, k, table.device))
    table[n_rows(cfg):].zero_()


def initial_rows(cfg: dict, seed: int, gids: torch.Tensor) -> torch.Tensor:
    """The initial rows of the global row ids ``gids`` (1-D int64) as [n, D]
    f32, each block made again where some id falls in it."""
    out = torch.empty((gids.numel(), cfg["embed_dim"]), dtype=torch.float32, device=gids.device)
    for s, k, first, rows in blocks(cfg):
        sel = (gids >= first) & (gids < first + rows)
        if bool(sel.any()):
            out[sel] = table_block(cfg, seed, s, k, gids.device)[gids[sel] - first]
    return out


def dense_weights(cfg: dict, seed: int, device) -> dict:
    """Every parameter but the table, by name, f32 on ``device``
    (``reference/dlrm_dcnv2.init``)."""
    from benchmark.reference import dlrm_dcnv2

    g = zipf.generator(seed, device, 4)

    def randn(*shape, std=1.0):
        return torch.randn(shape, generator=g, device=device, dtype=torch.float32) * std

    return dlrm_dcnv2.init(cfg, randn)
