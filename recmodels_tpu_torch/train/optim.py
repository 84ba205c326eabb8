"""Dense-parameter optimizers: the optax transformations that the JAX
engine uses (``recmodels_tpu/train/engine.py``: ``optax.adam``,
``optax.adagrad``, ``optax.sgd``), as plain functions on lists of tensors.

Each ``update`` takes the parameter leaves, their grads, the state and the
learning rate, updates the parameters (and the state's tensors) in place,
and returns the new state. The formulas and their order of operations are
optax 0.2's:

* adam:    mu = (1-b1) g + b1 mu;  nu = (1-b2) g^2 + b2 nu;  t = count + 1;
           p += -lr * (mu / (1-b1^t)) / (sqrt(nu / (1-b2^t) + eps_root) + eps)
* adagrad: s = g^2 + s;  p += -lr * (s > 0 ? rsqrt(s + eps) : 0) * g
* sgd:     p += -lr * g

The bias corrections 1 - b^t are computed in f32, as optax does. The
multi-tensor ``torch._foreach_*`` ops keep each formula's roundings (one
operation per step, no fused multiply-add) while launching a few kernels
per step instead of a few per leaf. Learning-rate schedules and weight
decay come with a later slice.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List

import torch

from recmodels_tpu_torch.embedding.update import bias_correction

Tensors = List[torch.Tensor]


@dataclasses.dataclass(frozen=True)
class DenseOptimizer:
    """init(params) -> state; update(params, grads, state, lr) -> state."""

    name: str
    init: Callable[[Tensors], dict]
    update: Callable[[Tensors, Tensors, dict, float], dict]


def adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         eps_root: float = 0.0) -> DenseOptimizer:
    def init(params: Tensors) -> dict:
        return {"count": 0, "mu": [torch.zeros_like(p) for p in params],
                "nu": [torch.zeros_like(p) for p in params]}

    def update(params: Tensors, grads: Tensors, state: dict, lr: float) -> dict:
        mu = torch._foreach_add(torch._foreach_mul(grads, 1.0 - b1),
                                torch._foreach_mul(state["mu"], b1))
        nu = torch._foreach_add(torch._foreach_mul(torch._foreach_mul(grads, grads), 1.0 - b2),
                                torch._foreach_mul(state["nu"], b2))
        count = state["count"] + 1
        mu_hat = torch._foreach_div(mu, bias_correction(b1, count))
        nu_hat = torch._foreach_div(nu, bias_correction(b2, count))
        if eps_root:
            torch._foreach_add_(nu_hat, eps_root)
        den = torch._foreach_sqrt(nu_hat)
        torch._foreach_add_(den, eps)
        step = torch._foreach_div(mu_hat, den)
        torch._foreach_mul_(step, -lr)
        torch._foreach_add_(params, step)
        return {"count": count, "mu": mu, "nu": nu}

    return DenseOptimizer("adam", init, update)


def adagrad(initial_accumulator_value: float = 0.1, eps: float = 1e-7) -> DenseOptimizer:
    def init(params: Tensors) -> dict:
        return {"sum_of_squares": [torch.full_like(p, initial_accumulator_value) for p in params]}

    def update(params: Tensors, grads: Tensors, state: dict, lr: float) -> dict:
        sos = torch._foreach_add(torch._foreach_mul(grads, grads), state["sum_of_squares"])
        for p, g, s in zip(params, grads, sos):
            scale = torch.where(s > 0, torch.rsqrt(s + eps), torch.zeros_like(s))
            p.add_(-lr * (scale * g))
        return {"sum_of_squares": sos}

    return DenseOptimizer("adagrad", init, update)


def sgd() -> DenseOptimizer:
    def update(params: Tensors, grads: Tensors, state: dict, lr: float) -> dict:
        torch._foreach_add_(params, torch._foreach_mul(grads, -lr))
        return state

    return DenseOptimizer("sgd", lambda params: {}, update)


def get_dense_optimizer(name: str) -> DenseOptimizer:
    if name == "adam":
        return adam()
    if name == "adagrad":
        return adagrad()
    if name == "sgd":
        return sgd()
    raise ValueError(f"unknown dense optimizer {name}")
