"""Plain MLP tower (port of ``recmodels_tpu/nn/mlp.py``).

Parameters are a list of ``{"w": [in, out], "b": [out]}`` f32 dicts, the JAX
package's layout (``nn.Linear`` would store ``[out, in]``), so artifacts
carry over without transposes. He init for ReLU layers, Glorot-style for the
linear output.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch


def mlp_init(generator: torch.Generator, in_dim: int, hidden: Sequence[int],
             out_dim: int | None = None, device="cpu") -> list[dict]:
    """Build [in_dim -> hidden... (-> out_dim, linear)] params."""
    sizes = [in_dim, *hidden] + ([out_dim] if out_dim is not None else [])
    layers = []
    for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
        last = out_dim is not None and i == len(sizes) - 2
        scale = math.sqrt(2.0 / a) if not last else math.sqrt(1.0 / a)
        w = torch.randn((a, b), generator=generator, device=device, dtype=torch.float32)
        layers.append({"w": w * scale, "b": torch.zeros((b,), device=device)})
    return layers


def mlp_apply(layers: list[dict], x: torch.Tensor, final_linear: bool,
              compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Forward; the last layer has no ReLU when ``final_linear``.

    The JAX package's rounding points: operands in ``compute_dtype``, the
    product summed in f32, the f32 bias added, ReLU, then a cast back to
    ``compute_dtype`` between layers."""
    h = x.to(compute_dtype)
    n = len(layers)
    for i, layer in enumerate(layers):
        h = _product_f32(h, layer["w"].to(compute_dtype)) + layer["b"]
        if not (final_linear and i == n - 1):
            h = torch.relu(h)
        h = h.to(compute_dtype)
    return h.float()


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of two bf16 matrices summed in f32. On the card cuBLAS
    returns the f32 sum of the bf16 tensor-core products; the CPU has no
    such product, so it widens the operands to f32 (exactly) and multiplies
    in f32, which is the same sum in another order."""
    if a.device.type == "cpu":
        return a.float() @ b.float()
    return torch.mm(a, b, out_dtype=torch.float32)


class ProductF32(torch.autograd.Function):
    """bf16 ``a @ b`` -> f32, with the transpose rule JAX gives a
    ``preferred_element_type=float32`` product: each operand's grad is the
    f32 sum of the cotangent against the other operand, rounded to bf16. The
    backward rounds the cotangent to bf16 first so that both of its products
    are bf16 products too; on the MLP's path that cast is exact, because
    every layer's output is rounded to bf16 and so is its cotangent."""

    @staticmethod
    def forward(ctx, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(a, b)
        return _mm_f32(a, b)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        a, b = ctx.saved_tensors
        g = g.to(torch.bfloat16)
        ga = _mm_f32(g, b.t()).to(torch.bfloat16) if ctx.needs_input_grad[0] else None
        gb = _mm_f32(a.t(), g).to(torch.bfloat16) if ctx.needs_input_grad[1] else None
        return ga, gb


def _product_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` summed in f32 for bf16 or f32 operands. A bf16
    ``torch.matmul`` would round the product to bf16 before the bias add."""
    if a.dtype == torch.float32:
        return a @ b.float()
    return ProductF32.apply(a, b)
