"""Operations and bytes that a DLRM-DCNv2 step needs (``reference/dlrm_dcnv2.py``),
from the configuration and from the ids a batch holds: what its whole-step
share of the peak and its kernels' roofline shares divide by. As
``counts.py``: each input byte read once, each output byte written once, a
table row a batch touches counted once however many of its ids name it; a
multiply-add is 2.

* ``step_flops``: forward, the bag sums, the bottom MLP, the cross layers'
  two products and three elementwise terms a value, the top MLP; training
  adds twice the forward's products (each operand's grad) and the
  elementwise terms again, the optimizers' elementwise work left out.
* ``bag_gather_bytes``: the pooled gather's distinct rows read once (f32),
  its ids (int32) read once, the pooled rows written once (bf16).
* #4's bytes at d = 128 are ``counts.adagrad_update_bytes``.
"""

from __future__ import annotations


def _mlp(sizes) -> int:
    return sum(2 * a * c for a, c in zip(sizes[:-1], sizes[1:]))


def forward_flops(cfg: dict) -> dict:
    """An example's forward operations by part."""
    d = cfg["embed_dim"]
    x0 = (cfg["n_slots"] + 1) * d
    return {"bags": (sum(cfg["hotness"]) - cfg["n_slots"]) * d,
            "bottom": _mlp([cfg["n_dense"], *cfg["bottom"]]),
            "cross_products": cfg["n_cross"] * 2 * (2 * x0 * cfg["low_rank"]),
            "cross_elementwise": cfg["n_cross"] * 3 * x0,
            "top": _mlp([x0, *cfg["top"], 1])}


def step_flops(cfg: dict, b: int, train: bool = True) -> int:
    """The model's operations for ``b`` examples: forward, and with
    ``train`` the backward too."""
    f = forward_flops(cfg)
    total = sum(f.values())
    if train:
        total += 2 * (f["bottom"] + f["cross_products"] + f["top"]) + f["cross_elementwise"] + f["bags"]
    return b * total


def bag_gather_bytes(unique_rows: float, n_ids: float, n_bags: float, d: int, out_elem: int = 2) -> float:
    """The pooled bag gather: distinct rows [U, d] f32 read once, the ids
    read once, the pooled rows [n_bags, d] written once."""
    return unique_rows * d * 4 + n_ids * 4 + n_bags * d * out_elem
