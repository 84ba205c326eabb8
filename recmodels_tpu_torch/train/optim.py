"""Dense-parameter optimizers: the optax transformations that the JAX
engine uses (``recmodels_tpu/train/engine.py``: ``optax.adam``,
``optax.adagrad``, ``optax.sgd``), as plain functions on lists of tensors.

Each ``update`` takes the parameter leaves, their grads, the state and the
learning rate, updates the parameters and the state's tensors in place, and
returns the state: a CUDA graph of the training step then reads and writes
the same tensors on every replay. Adam's ``count`` is a 0-d int32 tensor on
the parameters' device, as optax keeps it, and its bias corrections are
computed there from it. The formulas and their order of operations are
optax 0.2's:

* adam:    mu = (1-b1) g + b1 mu;  nu = (1-b2) g^2 + b2 nu;  t = count + 1;
           p += -lr * (mu / (1-b1^t)) / (sqrt(nu / (1-b2^t) + eps_root) + eps)
* adagrad: s = g^2 + s;  p += -lr * (s > 0 ? rsqrt(s + eps) : 0) * g
* sgd:     p += -lr * g

The bias corrections 1 - b^t are computed in f32, as optax does. The
multi-tensor ``torch._foreach_*`` ops keep each formula's roundings (one
operation per step, no fused multiply-add; b1*mu + (1-b1)*g is the same sum
as optax's in the other order, and IEEE addition commutes) while launching
a few kernels per step instead of a few per leaf. Learning-rate schedules and weight
decay come with a later slice.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List

import torch

from recmodels_tpu_torch.embedding.update import bias_corrections, device_constant

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
        return {"count": torch.zeros((), dtype=torch.int32, device=params[0].device),
                "mu": [torch.zeros_like(p) for p in params],
                "nu": [torch.zeros_like(p) for p in params]}

    def update(params: Tensors, grads: Tensors, state: dict, lr: float) -> dict:
        mu, nu, count = state["mu"], state["nu"], state["count"]
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, torch._foreach_mul(grads, 1.0 - b1))
        g2 = torch._foreach_mul(grads, grads)
        torch._foreach_mul_(g2, 1.0 - b2)
        torch._foreach_mul_(nu, b2)
        torch._foreach_add_(nu, g2)
        count.add_(1)
        bc1, bc2 = bias_corrections(device_constant((b1, b2), count.device), count).unbind()
        mu_hat = torch._foreach_div(mu, bc1)
        nu_hat = torch._foreach_div(nu, bc2)
        if eps_root:
            torch._foreach_add_(nu_hat, eps_root)
        den = torch._foreach_sqrt(nu_hat)
        torch._foreach_add_(den, eps)
        step = torch._foreach_div(mu_hat, den)
        torch._foreach_mul_(step, -lr)
        torch._foreach_add_(params, step)
        return state

    return DenseOptimizer("adam", init, update)


def adagrad(initial_accumulator_value: float = 0.1, eps: float = 1e-7) -> DenseOptimizer:
    def init(params: Tensors) -> dict:
        return {"sum_of_squares": [torch.full_like(p, initial_accumulator_value) for p in params]}

    def update(params: Tensors, grads: Tensors, state: dict, lr: float) -> dict:
        sos = state["sum_of_squares"]
        torch._foreach_add_(sos, torch._foreach_mul(grads, grads))
        for p, g, s in zip(params, grads, sos):
            scale = torch.where(s > 0, torch.rsqrt(s + eps), torch.zeros_like(s))
            p.add_(-lr * (scale * g))
        return state

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
