"""Operations and bytes that the work needs, from shapes and from the ids a
batch holds: what a roofline share divides by. The program's kernels may
read more or compute more; these count what the inputs need.

* Bytes: each input byte read once, each output byte written once; a table
  row that a batch touches counts once however many of its ids name it.
* Operations: a multiply-add is 2. The CIN counts its least-work forms (the
  last layer pooled over D before its weights), the forms of the bounds in
  ``PERF.md``'s kernel table (#3, #5).

``peak`` reads the chip's published peaks from ``peaks.json`` by the card's
name; a card not listed gives None, and no roofline is reported for it.
"""

from __future__ import annotations

import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).resolve().parent / "peaks.json").read_text())


def peak(card: str, what: str):
    entry = PEAKS["cards"].get(card)
    return None if entry is None else entry[what]


def bound_ms(card: str, flops: float = 0.0, nbytes: float = 0.0, flops_kind: str = "bf16_flops_per_s"):
    """The least time the card could take: the larger of operations over
    the peak rate and bytes over the memory bandwidth, in ms; None for a
    card not in the table."""
    rate, bw = peak(card, flops_kind), peak(card, "hbm_bytes_per_s")
    if rate is None or bw is None:
        return None
    return max(flops / rate, nbytes / bw) * 1e3


# ------------------------------------------------------------------ CIN
def cin_forward_flops(b: int, m: int, d: int, sizes) -> int:
    """#3: every layer but the last as ``X^k = W^k (X^{k-1} * X0)`` (2 H_k
    H_{k-1} m D a example); the last pooled first: ``t = sum_d X^{k-1} X0``
    (2 H_{k-1} m D), then ``t W^k`` (2 H_{k-1} m H_k)."""
    h_prev, total = m, 0
    for k, h in enumerate(sizes):
        if k < len(sizes) - 1:
            total += 2 * h * h_prev * m * d
        else:
            total += 2 * h_prev * m * d + 2 * h_prev * m * h
        h_prev = h
    return b * total


def cin_backward_flops(b: int, m: int, d: int, sizes) -> int:
    """#5: the transposes of ``cin_forward_flops``' products, two for each
    (the weights' grad and the input's), and the outer product's grad into
    both of its factors (2 multiply-adds an element of ``X^{k-1} * X0``) for
    every layer but the last."""
    h_prev, total = m, 0
    for k, h in enumerate(sizes):
        if k < len(sizes) - 1:
            total += 2 * (2 * h * h_prev * m * d) + 2 * (2 * h_prev * m * d)
        else:
            total += 2 * (2 * h_prev * m * d) + 2 * (2 * h_prev * m * h)
        h_prev = h
    return b * total


# ------------------------------------------------------------------ MLP, FM
def mlp_forward_flops(b: int, in_dim: int, hidden, out_dim: int = 1) -> int:
    sizes = [in_dim, *hidden, out_dim]
    return b * sum(2 * a * c for a, c in zip(sizes[:-1], sizes[1:]))


def mlp_backward_flops(b: int, in_dim: int, hidden, out_dim: int = 1) -> int:
    """The weights' grads and the inputs' grads (the first layer's too: it
    flows to the rows)."""
    return 2 * mlp_forward_flops(b, in_dim, hidden, out_dim)


def fm_flops(b: int, m: int, d: int, backward: bool) -> int:
    """FM's sum-square form: s = sum_j e (m D adds), s^2 and e^2 (D + m D
    multiplies), their sums; backward g (s - e) for each element."""
    fwd = b * (m * d + d + m * d + d + m * d)
    return fwd + (b * 2 * m * d if backward else 0)


def linear_flops(b: int, m: int, n_dense: int, p_dim: int) -> int:
    """The first-order sum, dense . w_dense and pools . w_cin."""
    return b * (m + 2 * n_dense + 2 * p_dim)


def step_flops(cfg: dict, b: int, train: bool = True) -> int:
    """The model's operations for ``b`` examples: forward, and with
    ``train`` backward too (the optimizers' elementwise work is left out)."""
    m, d = cfg["n_slots"], cfg["embed_dim"]
    in_dim = m * d + cfg["n_dense"]
    total = mlp_forward_flops(b, in_dim, cfg["hidden"])
    if train:
        total += mlp_backward_flops(b, in_dim, cfg["hidden"])
    p_dim = 0
    if cfg["model"] == "xdeepfm":
        p_dim = sum(cfg["cin_sizes"])
        total += cin_forward_flops(b, m, d, cfg["cin_sizes"])
        if train:
            total += cin_backward_flops(b, m, d, cfg["cin_sizes"])
    elif cfg["model"] == "deepfm":
        total += fm_flops(b, m, d, train)
    lin = linear_flops(b, m, cfg["n_dense"], p_dim)
    return total + (2 * lin if train else lin)


# ------------------------------------------------------------ gather, update
def gather_bytes(unique_rows: int, n_ids: int, d1: int, out_elem: int = 2, table_elem: int = 4) -> int:
    """#1: the unique rows read once, the ids (int32) read once, the output
    [n_ids, d1] written once."""
    return unique_rows * d1 * table_elem + n_ids * 4 + n_ids * d1 * out_elem


def adagrad_update_bytes(unique_rows: int, n_ids: int, d1: int, grad_elem: int = 2) -> int:
    """#4: each unique touched row of the table and of its accumulator read
    and written once (f32), the grads [n_ids, d1] and the sorted ids read
    once."""
    return unique_rows * d1 * 4 * 4 + n_ids * d1 * grad_elem + n_ids * 4


def expected_unique_uniform(b: int, n_slots: int, vocab: int) -> float:
    """Expected distinct rows of a batch whose ids are uniform over each
    slot's vocab: ``V (1 - (1 - 1/V)^B)`` a slot."""
    return n_slots * vocab * (1.0 - (1.0 - 1.0 / vocab) ** b)
