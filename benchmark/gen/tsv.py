"""Criteo-format TSV text from the Zipf generator.

A line is ``label \\t 13 integer counts \\t 26 categorical tokens``, fields
separated by tabs, an empty field where a value is missing, as in the
Criteo display-ads logs. A slot's token is the 8-hex-digit form of a
32-bit value that is a bijection of the example's Zipf rank in that slot
(an odd multiplier mod 2**32, offset per slot and per seed), so a rank
always reads as the same token and two ranks never share one; hashing
tokens into buckets is left to the reader, as with the real logs.

The text is built as one byte tensor on the generator's device, vectorised
(a fixed-width grid of characters and a mask of those that are kept), and
written with one call.
"""

from __future__ import annotations

import torch

from benchmark.gen import zipf

DENSE_DIGITS = 7  # counts are clipped below 10**7
TOKEN_MULT = 2654435761  # odd: rank -> token is a bijection mod 2**32
TAB, NEWLINE = 9, 10
_HEX = b"0123456789abcdef"


def tokens_of(ranks: torch.Tensor, seed: int) -> torch.Tensor:
    """[n, slots] int64 ranks -> 32-bit token values as int64."""
    n_slots = ranks.shape[1]
    offset = zipf.derive_seed(seed, 2) & 0xFFFFFFFF
    slot_off = torch.arange(n_slots, dtype=torch.int64, device=ranks.device) * 0x9E3779B9
    return ((ranks + 1) * TOKEN_MULT + slot_off + offset) & 0xFFFFFFFF


def lines(counts: torch.Tensor, tokens: torch.Tensor, missing: torch.Tensor,
          labels: torch.Tensor) -> torch.Tensor:
    """The text of n lines as a 1-D uint8 tensor. ``counts`` [n, 13] f32
    (NaN: missing), ``tokens`` [n, 26] int64, ``missing`` [n, 26] bool (an
    empty field), ``labels`` [n] f32."""
    dev = counts.device
    n, n_dense = counts.shape
    n_slots = tokens.shape[1]
    cols = []  # (chars [n, w] uint8, keep [n, w] bool)
    ones = lambda w: torch.ones((n, w), dtype=torch.bool, device=dev)  # noqa: E731

    def const(c, w=1):
        return torch.full((n, w), c, dtype=torch.uint8, device=dev), ones(w)

    cols.append(((labels.to(torch.uint8) + ord("0"))[:, None], ones(1)))
    cols.append(const(TAB))
    present = ~torch.isnan(counts)
    v = torch.nan_to_num(counts, nan=0.0).to(torch.int64)
    pow10 = 10 ** torch.arange(DENSE_DIGITS - 1, -1, -1, dtype=torch.int64, device=dev)
    nd = torch.ones_like(v)
    for k in range(1, DENSE_DIGITS):
        nd += (v >= 10 ** k).to(torch.int64)
    pos = torch.arange(DENSE_DIGITS, device=dev)
    for j in range(n_dense):
        digits = (v[:, j:j + 1] // pow10) % 10
        keep = (pos[None, :] >= DENSE_DIGITS - nd[:, j:j + 1]) & present[:, j:j + 1]
        cols.append(((digits + ord("0")).to(torch.uint8), keep))
        cols.append(const(TAB))
    hexchars = torch.tensor(list(_HEX), dtype=torch.uint8, device=dev)
    shifts = torch.arange(28, -4, -4, dtype=torch.int64, device=dev)
    for s in range(n_slots):
        nib = (tokens[:, s:s + 1] >> shifts) & 0xF
        keep = ~missing[:, s:s + 1].expand(n, 8)
        cols.append((hexchars[nib], keep))
        cols.append(const(NEWLINE if s == n_slots - 1 else TAB))
    chars = torch.cat([c for c, _ in cols], dim=1)
    keep = torch.cat([k for _, k in cols], dim=1)
    return chars[keep]


def write(path: str, slots: zipf.ZipfSlots, n_rows: int, n_dense: int, params: dict, seed: int,
          g: torch.Generator, block: int = 1 << 18) -> int:
    """Write ``n_rows`` lines drawn from ``slots`` to ``path`` in blocks of
    ``block`` rows; returns the bytes written."""
    total = 0
    with open(path, "wb") as f:
        for start in range(0, n_rows, block):
            n = min(block, n_rows - start)
            ranks = slots.ranks(n, g)
            counts = zipf.dense_counts(n, n_dense, params, g, slots.device)
            missing = torch.rand(ranks.shape, generator=g, device=slots.device) < params["cat_missing"]
            lab = zipf.labels(n, params, g, slots.device)
            text = lines(counts, tokens_of(ranks, seed), missing, lab).cpu().numpy()
            f.write(memoryview(text))
            total += text.size
    return total
