"""The benchmark's traffic generator, in plain PyTorch (on the card, or on the
CPU in the tests).

Each example holds one id a slot, drawn by a Zipf law of exponent ``s``
over the slot's distinct values (rank k in 1..C with probability
proportional to k**-s; ``s`` = 0 is uniform). A slot's C is its published
cardinality capped at its table rows (``slots_for``); a seeded injection
per slot scatters its C values over the slot's rows, as a hash would. Each example also holds 13 dense features, ``log1p`` of a
count drawn log-normally (some of them missing, which reads as 0), and a
0/1 label. Every draw comes from one ``torch.Generator`` on the device,
seeded from the run's seed, in a few large calls.

The program receives only these tensors (or the TSV text and numpy arrays
made from them).
"""

from __future__ import annotations

import torch

MASK63 = (1 << 63) - 1


def derive_seed(seed: int, *labels: int) -> int:
    """A 63-bit seed for a labelled stream of the run's ``seed``
    (splitmix64 steps over the seed and each label): any whole number,
    however large, gives a valid ``manual_seed``."""
    z = seed & ((1 << 64) - 1)
    for label in (0x5EED, *labels):
        z = (z + 0x9E3779B97F4A7C15 + label) & ((1 << 64) - 1)
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & ((1 << 64) - 1)
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & ((1 << 64) - 1)
        z ^= z >> 31
    return z & MASK63


def generator(seed: int, device, *labels: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(derive_seed(seed, *labels))


class ZipfSlots:
    """Zipf ranks and ids for every slot. ``cardinalities``: each slot's
    distinct values; ``rows``: a slot's table rows (the ids' range);
    ``exponent``: the law's s; the injections come from ``seed``."""

    def __init__(self, cardinalities, rows: int, exponent: float, seed: int, device):
        self.vocab_sizes = [int(c) for c in cardinalities]
        if not all(1 <= c <= rows for c in self.vocab_sizes):
            raise ValueError(f"cardinalities {self.vocab_sizes} must lie in 1..{rows}")
        self.exponent = float(exponent)
        self.device = torch.device(device)
        self._cdf = {}
        for v in set(self.vocab_sizes):
            w = torch.arange(1, v + 1, dtype=torch.float64, device=self.device).pow(-self.exponent)
            cdf = torch.cumsum(w, 0)
            self._cdf[v] = cdf / cdf[-1]
        g = generator(seed, self.device, 1)
        # perms[s][k]: the row of rank k + 1 in slot s
        self.perms = [torch.randperm(rows, generator=g, device=self.device)[:v].to(torch.int32)
                      for v in self.vocab_sizes]

    @property
    def n_slots(self) -> int:
        return len(self.vocab_sizes)

    def ranks(self, n: int, g: torch.Generator) -> torch.Tensor:
        """[n, n_slots] int64 ranks from 0 (the hottest) to V - 1."""
        u = torch.rand((n, self.n_slots), dtype=torch.float64, generator=g, device=self.device)
        out = torch.empty((n, self.n_slots), dtype=torch.int64, device=self.device)
        for s, v in enumerate(self.vocab_sizes):
            r = torch.searchsorted(self._cdf[v], u[:, s].contiguous(), right=True)
            out[:, s] = r.clamp_(max=v - 1)
        return out

    def ids_of(self, ranks: torch.Tensor) -> torch.Tensor:
        """Slot-local int32 ids of ``ranks``, through each slot's permutation."""
        out = torch.empty(ranks.shape, dtype=torch.int32, device=self.device)
        for s, perm in enumerate(self.perms):
            out[..., s] = perm[ranks[..., s]]
        return out


def slots_for(cfg: dict, params: dict, seed: int, device) -> ZipfSlots:
    """The slots of a cell: ``params["id_cardinalities"]`` (one a slot; the
    full table where absent) capped at ``cfg["vocab_size"]`` rows a slot,
    under ``params["zipf_exponent"]``."""
    rows = cfg["vocab_size"]
    cards = params.get("id_cardinalities", [rows] * cfg["n_slots"])
    if len(cards) != cfg["n_slots"]:
        raise ValueError(f"{len(cards)} id_cardinalities for {cfg['n_slots']} slots")
    return ZipfSlots([min(int(c), rows) for c in cards], rows, params["zipf_exponent"], seed, device)


def dense_counts(n: int, n_dense: int, params: dict, g: torch.Generator, device) -> torch.Tensor:
    """[n, n_dense] raw counts as f32, NaN where missing: floor of a
    log-normal (``dense_log_mean``, ``dense_log_std``), clipped to
    ``dense_max``; each value missing with probability ``dense_missing``."""
    x = torch.empty((n, n_dense), dtype=torch.float32, device=device)
    x.log_normal_(params["dense_log_mean"], params["dense_log_std"], generator=g)
    x = torch.floor(x).clamp_(max=params["dense_max"])
    miss = torch.rand((n, n_dense), generator=g, device=device) < params["dense_missing"]
    return torch.where(miss, torch.full_like(x, float("nan")), x)


def transform_dense(raw: torch.Tensor) -> torch.Tensor:
    """The Criteo transform the benchmark assumes of its data: log1p(max(x,
    0)), a missing value 0."""
    return torch.log1p(torch.nan_to_num(raw, nan=0.0).clamp(min=0.0))


def labels(n: int, params: dict, g: torch.Generator, device) -> torch.Tensor:
    """[n] f32 0/1 labels, 1 with probability ``label_rate``."""
    return (torch.rand((n,), generator=g, device=device) < params["label_rate"]).float()


def examples(slots: ZipfSlots, n: int, n_dense: int, params: dict, g: torch.Generator):
    """(dense [n, n_dense] f32 transformed, ids [n, n_slots] int32, labels
    [n] f32) on the slots' device."""
    dev = slots.device
    ranks = slots.ranks(n, g)
    dense = transform_dense(dense_counts(n, n_dense, params, g, dev))
    return dense, slots.ids_of(ranks), labels(n, params, g, dev)


def batch_pool(slots: ZipfSlots, n_batches: int, batch: int, n_dense: int, params: dict,
               g: torch.Generator):
    """A pool of batches stacked [n_batches, batch, ...] (dense, ids,
    labels)."""
    dense, ids, lab = examples(slots, n_batches * batch, n_dense, params, g)
    return (dense.reshape(n_batches, batch, n_dense), ids.reshape(n_batches, batch, -1),
            lab.reshape(n_batches, batch))
