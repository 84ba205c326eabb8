"""Op dispatch under the JAX package's names (``recmodels_tpu/ops/dispatch.py``).

``get_op(name)`` returns a function that chooses by the device of the
tensors it is called with, and by nothing else: no environment switch and
no backend probe. Ops with a CUDA kernel return the kernel module's entry
point, which takes the plain version for a CPU tensor and the kernel for a
CUDA tensor. Ops without a kernel yet run their plain version on the CPU
and raise ``NotImplementedError`` for a CUDA tensor, naming the ROADMAP item
that ports their TPU kernel; the plain version never stands in for a kernel
on the card.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from recmodels_tpu_torch.ops import interactions
from recmodels_tpu_torch.ops.cuda import interactions_cuda

_KERNELS: Dict[str, Callable] = {
    "cin_stack_dm_flat": interactions_cuda.cin_stack_dm_flat,
    "split_fused_rows": interactions_cuda.split_fused_rows_op,
}

# ops that run only on the CPU until their TPU kernels are ported
_CPU_ONLY: Dict[str, Callable] = {
    "cin_layer": interactions.cin_layer,
    "cin_stack": interactions.cin_stack,
    "cin_stack_dm": interactions.cin_stack_dm,
    "cin_stack_flat": interactions.cin_stack_flat,
}
_AWAITS = (
    "ROADMAP.md, queue 2: the generic CIN layer kernels "
    "(_cin_forward_2d, _cin_bwd_pallas) and transpose_minor2"
)


def _cpu_only(name: str, fn: Callable) -> Callable:
    def op(x: torch.Tensor, *args):
        if x.device.type != "cpu":
            raise NotImplementedError(f"{name}: no CUDA kernel yet; see {_AWAITS}")
        return fn(x, *args)

    op.__name__ = name
    op.__doc__ = fn.__doc__
    return op


def get_op(name: str) -> Callable:
    if name in _KERNELS:
        return _KERNELS[name]
    if name in _CPU_ONLY:
        return _cpu_only(name, _CPU_ONLY[name])
    raise KeyError(f"unknown op: {name}")
