"""Op dispatch under the JAX package's names (``recmodels_tpu/ops/dispatch.py``).

``get_op(name)`` returns the kernel module's entry point, which chooses by
the device of the tensors it is called with, and by nothing else: no
environment switch and no backend probe. A CPU tensor takes the plain
version; a CUDA tensor launches the kernels (or raises on what they do not
take); the plain version never stands in for a kernel on the card.

``dcn_cross_layer``, ``pnn_inner_products`` and ``pnn_outer_product`` have
a kernel in neither package (the JAX package's TPU entries return its
reference): they are the plain ops on every device.
"""

from __future__ import annotations

from typing import Callable, Dict

from recmodels_tpu_torch.ops import interactions
from recmodels_tpu_torch.ops.cuda import interactions_cuda

_KERNELS: Dict[str, Callable] = {
    "cin_layer": interactions_cuda.cin_layer,
    "cin_stack": interactions_cuda.cin_stack,
    "cin_stack_dm": interactions_cuda.cin_stack_dm,
    "cin_stack_flat": interactions_cuda.cin_stack_flat,
    "cin_stack_dm_flat": interactions_cuda.cin_stack_dm_flat,
    "split_fused_rows": interactions_cuda.split_fused_rows_op,
    "fm_pairwise": interactions_cuda.fm_pairwise_op,
    "dcn_cross_stack": interactions_cuda.dcn_cross_stack_op,
    "dcn_cross_layer": interactions.dcn_cross_layer,
    "pnn_inner_products": interactions.pnn_inner_products,
    "pnn_outer_product": interactions.pnn_outer_product,
}


def get_op(name: str) -> Callable:
    if name in _KERNELS:
        return _KERNELS[name]
    raise KeyError(f"unknown op: {name}")
