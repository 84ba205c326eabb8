"""Dense-parameter optimizers: the optax transformations that the JAX
engine uses (``recmodels_tpu/train/engine.py``: ``optax.adam``,
``optax.adamw``, ``optax.adagrad``, ``optax.sgd``, the last two chained
after ``optax.add_decayed_weights`` when there is weight decay), as plain
functions on lists of tensors.

Each ``update`` takes the parameter leaves, their grads, the state and the
learning rate, updates the parameters and the state's tensors in place, and
returns the state: a CUDA graph of the training step then reads and writes
the same tensors on every replay. Adam's ``count`` is a 0-d int32 tensor on
the parameters' device, as optax keeps it, and its bias corrections are
computed there from it. The formulas and their order of operations are
optax 0.2's:

* adam:    mu = (1-b1) g + b1 mu;  nu = (1-b2) g^2 + b2 nu;  t = count + 1;
           u = (mu / (1-b1^t)) / (sqrt(nu / (1-b2^t) + eps_root) + eps);
           adamw adds the decay to the direction: u = u + wd p;  p += -lr * u
* adagrad: g = g + wd p (with decay);  s = g^2 + s;
           p += -lr * (s > 0 ? rsqrt(s + eps) : 0) * g
* sgd:     g = g + wd p (with decay);  p += -lr * g

p in a decay term is the value before the update. The bias corrections 1 -
b^t are computed in f32, as optax does. The multi-tensor ``torch._foreach_*``
ops keep each formula's roundings (one operation per step, no fused
multiply-add; b1*mu + (1-b1)*g is the same sum as optax's in the other
order, and IEEE addition commutes) while launching a few kernels per step
instead of a few per leaf.

The learning rate is a float or a schedule (``train/schedules.py``). An
optimizer built with ``scheduled=True`` keeps the schedule's own step count
in its state, ``schedule_count`` (optax's ``ScaleByScheduleState.count``,
apart from Adam's ``count``), a 0-d int32 tensor that the update reads and
advances in place: update k reads ``lr(k)``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List

import torch

from recmodels_tpu_torch.embedding.update import bias_corrections, device_constant

Tensors = List[torch.Tensor]


@dataclasses.dataclass(frozen=True)
class DenseOptimizer:
    """init(params) -> state; update(params, grads, state, lr) -> state,
    ``lr`` a float or, when ``scheduled``, a schedule."""

    name: str
    init: Callable[[Tensors], dict]
    update: Callable[[Tensors, Tensors, dict, object], dict]
    scheduled: bool = False


def _current_lr(lr, state: dict):
    """This update's lr: the float, or the schedule at the state's
    ``schedule_count`` (a 0-d f32 tensor), advancing the count."""
    if not callable(lr):
        return lr
    count = state["schedule_count"]
    value = lr(count)
    count.add_(1)
    return value


def _decayed(params: Tensors, grads: Tensors, weight_decay: float) -> Tensors:
    """optax's ``add_decayed_weights``: g + wd p."""
    return torch._foreach_add(grads, torch._foreach_mul(params, weight_decay))


def adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8, eps_root: float = 0.0,
         weight_decay: float = 0.0) -> Callable:
    def init(params: Tensors) -> dict:
        return {"count": torch.zeros((), dtype=torch.int32, device=params[0].device),
                "mu": [torch.zeros_like(p) for p in params],
                "nu": [torch.zeros_like(p) for p in params]}

    def update(params: Tensors, grads: Tensors, state: dict, lr) -> dict:
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
        if weight_decay:
            torch._foreach_add_(step, torch._foreach_mul(params, weight_decay))
        torch._foreach_mul_(step, -_current_lr(lr, state))
        torch._foreach_add_(params, step)
        return state

    return init, update


def adagrad(initial_accumulator_value: float = 0.1, eps: float = 1e-7,
            weight_decay: float = 0.0) -> Callable:
    def init(params: Tensors) -> dict:
        return {"sum_of_squares": [torch.full_like(p, initial_accumulator_value) for p in params]}

    def update(params: Tensors, grads: Tensors, state: dict, lr) -> dict:
        if weight_decay:
            grads = _decayed(params, grads, weight_decay)
        sos = state["sum_of_squares"]
        torch._foreach_add_(sos, torch._foreach_mul(grads, grads))
        neg_lr = -_current_lr(lr, state)
        for p, g, s in zip(params, grads, sos):
            scale = torch.where(s > 0, torch.rsqrt(s + eps), torch.zeros_like(s))
            p.add_(neg_lr * (scale * g))
        return state

    return init, update


def sgd(weight_decay: float = 0.0) -> Callable:
    def update(params: Tensors, grads: Tensors, state: dict, lr) -> dict:
        if weight_decay:
            grads = _decayed(params, grads, weight_decay)
        torch._foreach_add_(params, torch._foreach_mul(grads, -_current_lr(lr, state)))
        return state

    return (lambda params: {}), update


def get_dense_optimizer(name: str, weight_decay: float = 0.0, scheduled: bool = False) -> DenseOptimizer:
    """The dense optimizer ``name`` (adam, adagrad or sgd) with optax's
    decoupled ``weight_decay`` (adam: adamw); ``scheduled`` adds the
    schedule's count to its state."""
    builders = {"adam": adam, "adagrad": adagrad, "sgd": sgd}
    if name not in builders:
        raise ValueError(f"unknown dense optimizer {name}")
    init, update = builders[name](weight_decay=weight_decay)
    if scheduled:
        def init_scheduled(params: Tensors, init=init) -> dict:
            return {**init(params),
                    "schedule_count": torch.zeros((), dtype=torch.int32, device=params[0].device)}

        return DenseOptimizer(name, init_scheduled, update, scheduled=True)
    return DenseOptimizer(name, init, update)
