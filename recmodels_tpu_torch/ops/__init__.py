"""Interaction ops: plain PyTorch versions (``interactions``), CUDA kernels
(``cuda/``) and the dispatch that chooses between them by tensor device."""
from recmodels_tpu_torch.ops.interactions import (
    cin_layer,
    dcn_cross_layer,
    fm_pairwise,
    pnn_inner_products,
    pnn_outer_product,
)

__all__ = [
    "fm_pairwise",
    "dcn_cross_layer",
    "pnn_inner_products",
    "pnn_outer_product",
    "cin_layer",
]
