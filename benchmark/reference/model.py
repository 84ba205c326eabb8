"""The plain f32 model shared by the configurations: one first-order weight
and one embedding row a slot, a DNN, and the family's own interaction term
(``reference/models/<model>.py``, found by the configuration's ``model``).

    logit = bias + sum_j wide[b, j] + dense . w_dense + DNN(e, dense)
            + interaction(e)

The DNN takes the rows slot-major (``e[b, j, d]`` at ``j * D + d``), then
the dense features; ReLU layers, the last linear. This file and the
families' imports ``torch`` alone: nothing of the program.

``q`` is a rounding applied where a lower-precision program would round
(``precision.py``): the identity for the reference, a coarser format for
the control.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

import torch
import torch.nn.functional as F

MODELS = Path(__file__).resolve().parent / "models"
_FAMILIES: dict = {}


def family(cfg: dict):
    """The configuration's model family: a module with ``init(cfg, randn)
    -> {name: tensor}`` (its own parameters) and ``interaction(cfg, params,
    e, q) -> [B]``."""
    name = cfg["model"]
    if name not in _FAMILIES:
        path = MODELS / f"{name}.py"
        if not path.exists():
            raise ValueError(f"no reference for model {name!r} ({path})")
        spec = importlib.util.spec_from_file_location(f"bench_reference_{name}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _FAMILIES[name] = mod
    return _FAMILIES[name]


def init(cfg: dict, randn) -> dict:
    """Every parameter but the table, by name: the family's, then the
    DNN's (He, the last layer 1/in), ``w_dense`` and ``bias``, all live.
    ``randn(*shape, std=)`` draws them."""
    out = dict(family(cfg).init(cfg, randn))
    sizes = [cfg["n_slots"] * cfg["embed_dim"] + cfg["n_dense"], *cfg["hidden"], 1]
    for k, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
        last = k == len(sizes) - 2
        out[f"mlp.{k}.w"] = randn(a, b, std=((1.0 if last else 2.0) / a) ** 0.5)
        out[f"mlp.{k}.b"] = randn(b, std=0.01)
    out["w_dense"] = randn(cfg["n_dense"], std=0.1)
    out["bias"] = randn(std=0.1).reshape(())
    return out


def mlp(h: torch.Tensor, params: dict, n_layers: int, q) -> torch.Tensor:
    """ReLU layers, the last linear; each layer's operands rounded by ``q``
    and its output too. Returns [B]."""
    for k in range(n_layers):
        h = q(h) @ q(params[f"mlp.{k}.w"]) + params[f"mlp.{k}.b"]
        if k < n_layers - 1:
            h = torch.relu(h)
        h = q(h)
    return h[:, 0]


def logits(cfg: dict, params: dict, rows: torch.Tensor, dense: torch.Tensor, q) -> torch.Tensor:
    """The model's logits [B] from gathered rows [B, m, D + 1] (the last
    column the first-order weight) and dense features [B, n_dense]."""
    d = cfg["embed_dim"]
    rows = q(rows)
    e, wide = rows[..., :d], rows[..., d]
    h = torch.cat([e.reshape(e.shape[0], -1), q(dense)], dim=1)
    y = params["bias"] + wide.sum(dim=1) + dense @ params["w_dense"] + mlp(h, params, len(cfg["hidden"]) + 1, q)
    return y + family(cfg).interaction(cfg, params, e, q)


def bce_sum(z: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return F.binary_cross_entropy_with_logits(z, labels, reduction="sum")
