"""Roundings for the reference: ``f32`` (none: the reference itself) and the
control's ``fp8``, the nearest precision below the bf16 that the
configurations state.

``fp8`` rounds each tensor to float8 e4m3 after scaling it so that its
largest magnitude maps to e4m3's largest finite value (448), then scales
back: per-tensor scaled fp8, the form a program that moved its bf16
arithmetic to fp8 would use. A rounding applies in both directions: the
cotangent that flows back through it is rounded the same way, as a
low-precision program's backward rounds its grads.
"""

from __future__ import annotations

import torch

E4M3_MAX = 448.0


def _fp8(x: torch.Tensor) -> torch.Tensor:
    amax = x.detach().abs().amax().float().clamp(min=1e-30)
    scale = E4M3_MAX / amax
    return (x.float() * scale).to(torch.float8_e4m3fn).float() / scale


class _Round(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, fn):
        ctx.fn = fn
        return fn(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.fn(g), None


def rounding(precision: str):
    """``q(tensor) -> tensor`` for ``precision`` (``f32`` or ``fp8``)."""
    if precision == "f32":
        return lambda x: x
    if precision == "fp8":
        return lambda x: _Round.apply(x, _fp8)
    raise ValueError(f"unknown precision {precision!r}")
