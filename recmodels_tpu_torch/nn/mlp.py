"""Plain MLP tower (port of ``recmodels_tpu/nn/mlp.py``).

Parameters are a list of ``{"w": [in, out], "b": [out]}`` f32 dicts, the JAX
package's layout (``nn.Linear`` would store ``[out, in]``), so artifacts
carry over without transposes. He init for ReLU layers, Glorot-style for the
linear output. In bf16 each layer is a cuBLAS product summed in f32 and one
pass of ``nn/mlp_epilogue.py`` for the bias, ReLU and rounding, with the
backward written out (``MlpStack``).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

from recmodels_tpu_torch.nn.mlp_epilogue import act_backward, bias_act
from recmodels_tpu_torch.utils import profiling


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
    ``compute_dtype`` between layers. In bf16 the layers run as ``MlpStack``
    when grads are wanted, else as its forward alone, and each call adds
    the number of layers to the counter ``mlp.fused_layers``
    (``utils/profiling.py``); in f32 PyTorch's ops run as they are."""
    h = x.to(compute_dtype)
    n = len(layers)
    if compute_dtype == torch.bfloat16 and n:
        profiling.count("mlp.fused_layers", n)
        ws = [layer["w"].to(compute_dtype) for layer in layers]
        bs = [layer["b"] for layer in layers]
        if torch.is_grad_enabled() and any(t.requires_grad for t in (h, *ws, *bs)):
            h = MlpStack.apply(final_linear, h, *(t for wb in zip(ws, bs) for t in wb))
        else:
            h = _stack_forward(final_linear, h, ws, bs)[-1]
        return h.float()
    for i, layer in enumerate(layers):
        h = h @ layer["w"].to(compute_dtype) + layer["b"]
        if not (final_linear and i == n - 1):
            h = torch.relu(h)
        h = h.to(compute_dtype)
    return h.float()


def _relu_at(final_linear: bool, n: int, i: int) -> bool:
    return not (final_linear and i == n - 1)


def _stack_forward(final_linear: bool, x: torch.Tensor, ws, bs) -> list[torch.Tensor]:
    """Each layer's input and, last, the stack's output: in bf16 ``bias_act``
    of each bf16 product summed in f32; in f32 ``addmm`` and ``relu``. The
    f32 branch serves ``models/wukong.WukongStack``, whose hand-written
    backward the CPU tests hold to the plain f32 reference at rtol 1e-5
    (``tests/test_torch_wukong.py``); f32 ``mlp_apply`` keeps autograd."""
    hs = [x]
    for i, (w, b) in enumerate(zip(ws, bs)):
        relu = _relu_at(final_linear, len(ws), i)
        if x.dtype == torch.bfloat16:
            hs.append(bias_act(_mm_f32(hs[-1], w), b, relu))
        else:
            h = torch.addmm(b, hs[-1], w)
            hs.append(torch.relu(h) if relu else h)
    return hs


def stack_backward(final_linear: bool, hs, ws, g: torch.Tensor, input_grad: bool = True,
                   weight_grads: bool = True) -> tuple:
    """The backward of ``_stack_forward``'s layers from the top (``MlpStack``'s
    docstring): ``hs`` each layer's input and, where the last layer has a
    ReLU, its output; ``g`` the output's cotangent. Returns (the input's
    cotangent in its dtype, or None unless ``input_grad``; [g_w_0, g_b_0,
    ...], the weights' grads None unless ``weight_grads``). In bf16 the
    bits of ``MlpStack``; in f32 the plain chain's (mask, batch sum,
    products), for ``WukongStack``'s f32 route alone, as ``_stack_forward``'s
    f32 branch."""
    n = len(ws)
    bf16 = hs[0].dtype == torch.bfloat16
    grads = [None] * (2 * n)
    g = g.contiguous()
    for i in reversed(range(n)):
        h = hs[i + 1] if _relu_at(final_linear, n, i) else None
        if bf16:
            gz, grads[2 * i + 1] = act_backward(g, h)
        else:
            gz = g if h is None else g.masked_fill(h <= 0, 0)
            grads[2 * i + 1] = gz.sum(dim=0)
        if weight_grads:
            grads[2 * i] = _mm_f32(hs[i].t(), gz).to(torch.bfloat16) if bf16 else hs[i].t() @ gz
        if i > 0 or input_grad:
            g = _mm_f32(gz, ws[i].t()) if bf16 else gz @ ws[i].t()
    return (g.to(hs[0].dtype) if input_grad else None), grads


class MlpStack(torch.autograd.Function):
    """The bf16 layers: ``forward(final_linear, x, w_0, b_0, w_1, ...)`` ->
    the last layer's bf16 output, with x and each ``w`` bf16 and each ``b``
    f32. Per layer the f32 product ``_mm_f32`` and ``bias_act`` (bias, ReLU
    and the rounding in one pass); it saves each layer's bf16 input, the
    output where the last layer has a ReLU, and the weights.

    The backward, from the top: ``act_backward`` of the cotangent (the
    layer above's f32 input grad, rounded there to bf16, or the stack's
    bf16 cotangent) gives ``g_z`` and the bias's f32 grad; ``g_w`` is the
    f32 sum of ``h^T g_z`` rounded to bf16 and ``g_in`` the f32 sum of ``g_z
    w^T``, rounded by the next layer's ``act_backward``, or to x's dtype for
    the stack's input, and not computed where x needs no grad. These are
    the bits of autograd through ``ProductF32``, the bias add, ``relu`` and
    the cast (JAX's transpose rule for the f32-summed product), except the
    bias grads' f32 summation order and the mask, which reads the bf16
    output (``nn/mlp_epilogue.py``)."""

    @staticmethod
    def forward(ctx, final_linear: bool, x: torch.Tensor, *wb: torch.Tensor) -> torch.Tensor:
        ws, bs = wb[0::2], wb[1::2]
        hs = _stack_forward(final_linear, x, ws, bs)
        ctx.final_linear = final_linear
        ctx.save_for_backward(*(hs if _relu_at(final_linear, len(ws), len(ws) - 1) else hs[:-1]), *ws)
        return hs[-1]

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        n = (len(ctx.needs_input_grad) - 2) // 2
        saved = ctx.saved_tensors
        hs, ws = saved[:-n], saved[-n:]
        g_in, grads = stack_backward(ctx.final_linear, hs, ws, g, ctx.needs_input_grad[1],
                                     any(ctx.needs_input_grad[2::2]))
        return (None, g_in, *grads)


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
    every layer's output is rounded to bf16 and so is its cotangent. With
    PyTorch's bias add, ``relu`` and cast it was the bf16 MLP's route
    before ``MlpStack``, which the tests hold ``MlpStack`` to."""

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
