"""Learning-rate schedules: port of ``recmodels_tpu/train/schedules.py``.

``build_lr_schedule`` takes the JAX package's kinds and arguments. Where
there is nothing to schedule (constant, no warmup) it returns the plain
float. Otherwise it returns a callable from a 0-d int32 step tensor to a 0-d
f32 lr tensor on the step's device, computed with tensor operations only: no
value goes through the host, so a CUDA graph of a step reads the lr of the
step it replays. The formulas and their order of operations are optax's (the
JAX package builds its schedules from optax):

* linear (``linear_schedule``): ``(init - end) * (1 - clip(t, 0, T) / T) + end``;
* cosine (``cosine_decay_schedule``): ``init * ((1 - a) * 0.5 * (1 +
  cos(pi * min(t, T) / T)) + a)`` with ``a = end / peak``;
* exponential (``exponential_decay``, not staircase): ``init * rate **
  (t / T)``, and ``init`` at t <= 0;
* a warmup (``join_schedules``): a linear ramp from 0 below the boundary,
  and the body at ``t - boundary`` from it on.

Each value is f32, the constants rounded to f32 once, as JAX rounds its
Python scalars; ``cos`` and ``pow`` may differ from XLA's by an ulp.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

KINDS = ("constant", "linear", "cosine", "exponential")

Schedule = Callable[[torch.Tensor], torch.Tensor]


def constant_schedule(value: float) -> Schedule:
    return lambda step: torch.full((), value, dtype=torch.float32, device=step.device)


def linear_schedule(init_value: float, end_value: float, transition_steps: int) -> Schedule:
    """optax's ``linear_schedule`` (a polynomial of power 1, begin 0)."""

    def schedule(step: torch.Tensor) -> torch.Tensor:
        count = torch.clamp(step, 0, transition_steps)
        frac = 1 - count / transition_steps
        return frac * (init_value - end_value) + end_value

    return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int, alpha: float) -> Schedule:
    """optax's ``cosine_decay_schedule`` with exponent 1."""

    def schedule(step: torch.Tensor) -> torch.Tensor:
        count = torch.clamp(step.float(), max=float(decay_steps))
        cosine = 0.5 * (1 + torch.cos(math.pi * count / float(decay_steps)))
        return init_value * ((1 - alpha) * cosine + alpha)

    return schedule


def exponential_decay(init_value: float, transition_steps: int, decay_rate: float) -> Schedule:
    """optax's ``exponential_decay`` (not staircase, begin 0)."""

    def schedule(step: torch.Tensor) -> torch.Tensor:
        p = step / transition_steps
        decayed = init_value * torch.pow(decay_rate, p)
        return torch.where(step <= 0, torch.full_like(decayed, init_value), decayed)

    return schedule


def join_schedules(schedules: list[Schedule], boundaries: list[int]) -> Schedule:
    """optax's ``join_schedules``: each later schedule counts from its
    boundary."""

    def schedule(step: torch.Tensor) -> torch.Tensor:
        out = schedules[0](step)
        for boundary, later in zip(boundaries, schedules[1:]):
            out = torch.where(step < boundary, out, later(step - boundary))
        return out

    return schedule


def build_lr_schedule(
    base_lr: float,
    kind: str = "constant",
    warmup_steps: int = 0,
    total_steps: int = 0,
    end_scale: float = 0.0,
    decay_rate: float = 0.96,
    decay_every: int = 1000,
) -> Schedule | float:
    """step -> lr; the plain float when there is nothing to schedule.

    kinds: constant | linear (to end_scale*base over total_steps) | cosine
    (optax's warmup_cosine_decay_schedule to end_scale*base) | exponential
    (base * decay_rate^(step/decay_every)); each with an optional linear
    warmup from 0 over warmup_steps. Raises ``ValueError`` for another kind.
    """
    if kind not in KINDS:
        raise ValueError(f"unknown lr schedule '{kind}'; have {KINDS}")
    if kind == "constant" and warmup_steps <= 0:
        return base_lr
    end = base_lr * end_scale
    if kind == "cosine":
        # optax.warmup_cosine_decay_schedule
        warmup = max(warmup_steps, 1)
        decay_steps = max(total_steps, warmup_steps + 1)
        alpha = 0.0 if base_lr == 0.0 else end / base_lr
        return join_schedules(
            [linear_schedule(0.0 if warmup_steps else base_lr, base_lr, warmup),
             cosine_decay_schedule(base_lr, decay_steps - warmup, alpha)],
            [warmup],
        )
    if kind == "linear":
        body = linear_schedule(base_lr, end, max(total_steps - warmup_steps, 1))
    elif kind == "exponential":
        body = exponential_decay(base_lr, max(decay_every, 1), decay_rate)
    else:  # constant body with warmup
        body = constant_schedule(base_lr)
    if warmup_steps > 0:
        return join_schedules([linear_schedule(0.0, base_lr, warmup_steps), body], [warmup_steps])
    return body
