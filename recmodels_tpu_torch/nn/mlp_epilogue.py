"""The bf16 MLP's epilogues: the CUDA kernels of ``csrc/mlp_epilogue.cu`` and
their plain PyTorch versions.

* ``bias_act(z, b, relu)``: a layer's f32 product ``z`` [B, N] and bias
  ``b`` [N] f32 -> ``h = bf16(relu(z + b))`` (``bf16(z + b)`` for a linear
  layer), one kernel (``mlp_bias_act_fwd_kernel``);
* ``act_backward(g, h)``: the cotangent ``g`` of ``h`` (f32 or bf16) and
  ``h`` (None for a linear layer) -> ``(g_z, g_b)``: ``g_z = bf16(g)``,
  zero where ``h <= 0``, and the bias's grad ``g_b`` [N] f32, the batch sum
  of ``g_z`` in f32; two kernels (``mlp_act_bwd_kernel``, then
  ``mlp_bias_grad_kernel`` over its per-block column sums).

The rounding points are those of the PyTorch chain they replace (``z + b``,
``torch.relu``, ``.to(bf16)``, and autograd's backward through it), so ``h``
and ``g_z`` have its bits; the mask reads bf16 ``h`` rather than the f32
ReLU output, which differ only for outputs in (0, 2^-134], which round to
bf16 zero. Only ``g_b``'s summation order differs between the versions.
NaN passes ``relu`` and, where ``h`` is NaN, the grad, as in the chain.

Each entry chooses by the device of its tensors: a CPU tensor takes the
plain version, a CUDA tensor launches the kernels or raises.
"""

from __future__ import annotations

import torch

from recmodels_tpu_torch.ops.cuda import build
from recmodels_tpu_torch.ops.cuda.launch import cuda_device, device_and_stream, require


def bias_act_reference(z: torch.Tensor, b: torch.Tensor, relu: bool) -> torch.Tensor:
    """Plain version of ``bias_act``: the chain it replaces."""
    y = z + b
    return (torch.relu(y) if relu else y).to(torch.bfloat16)


def _vec(n: int, *tensors: torch.Tensor) -> int:
    """8 (16-byte vectors) where a row is whole vectors and every tensor
    starts on a 16-byte boundary, else 1."""
    return 8 if n % 8 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors) else 1


def bias_act(z: torch.Tensor, b: torch.Tensor, relu: bool) -> torch.Tensor:
    """``bf16(relu(z + b))`` (``bf16(z + b)`` unless ``relu``) of contiguous
    ``z`` [B, N] f32 and ``b`` [N] f32, [B, N] bf16."""
    if z.device.type == "cpu":
        return bias_act_reference(z, b, relu)
    dev_t = cuda_device(z, "bias_act")
    require("bias_act z", z, (torch.float32,), 2, dev_t, align=4)
    require("bias_act b", b, (torch.float32,), 1, dev_t, align=4)
    rows, n = z.shape
    if b.shape != (n,):
        raise ValueError(f"bias_act: bias {tuple(b.shape)}, expected ({n},)")
    h = torch.empty((rows, n), dtype=torch.bfloat16, device=dev_t)
    dev, stream = device_and_stream(dev_t)
    err = build.library().rm_mlp_bias_act(dev, z.data_ptr(), b.data_ptr(), h.data_ptr(), rows, n, int(relu),
                                          _vec(n, z, b, h), stream)
    build.check(err, "bias_act")
    bias_act.launches += 1
    return h


bias_act.launches = 0  # kernel launches since the count was last set to 0


def act_backward_reference(g: torch.Tensor, h: torch.Tensor | None) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``act_backward``: g rounded to bf16, zero where
    ``h <= 0``, and its f32 batch sum."""
    gz = g.to(torch.bfloat16)
    if h is not None:
        gz = gz.masked_fill(h <= 0, 0)
    return gz, gz.float().sum(dim=0)


def act_backward(g: torch.Tensor, h: torch.Tensor | None) -> tuple[torch.Tensor, torch.Tensor]:
    """``(g_z, g_b)`` of contiguous ``g`` [B, N] (f32 or bf16) and ``h`` [B,
    N] bf16 (None: a linear layer): ``g_z`` [B, N] bf16 is g rounded to
    bf16, zero where ``h <= 0``; ``g_b`` [N] f32 its batch sum, in a fixed
    order (two calls give the same bits)."""
    if g.device.type == "cpu":
        return act_backward_reference(g, h)
    dev_t = cuda_device(g, "act_backward")
    require("act_backward g", g, (torch.float32, torch.bfloat16), 2, dev_t, align=g.element_size())
    rows, n = g.shape
    if h is not None:
        require("act_backward h", h, (torch.bfloat16,), 2, dev_t, align=2)
        if h.shape != g.shape:
            raise ValueError(f"act_backward: h {tuple(h.shape)}, expected {tuple(g.shape)}")
    gz = torch.empty((rows, n), dtype=torch.bfloat16, device=dev_t)
    gb = torch.empty((n,), dtype=torch.float32, device=dev_t)
    lib = build.library()
    vec = _vec(n, g, gz, *(() if h is None else (h,)))
    partials = torch.empty((lib.rm_mlp_partial_rows(rows, n, vec), n), dtype=torch.float32, device=dev_t)
    dev, stream = device_and_stream(dev_t)
    err = lib.rm_mlp_act_backward(dev, g.data_ptr(), None if h is None else h.data_ptr(), gz.data_ptr(),
                                  partials.data_ptr(), gb.data_ptr(), rows, n, int(g.dtype == torch.bfloat16),
                                  vec, stream)
    build.check(err, "act_backward")
    act_backward.launches += 1
    return gz, gb


act_backward.launches = 0  # calls (two kernels each) since the count was last set to 0
