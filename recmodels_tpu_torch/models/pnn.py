"""PNN — product-based neural network (arXiv:1611.00144); port of
``recmodels_tpu/models/pnn.py``.

embedding -> product layer -> MLP -> logit, the paper's first hidden layer
``relu(W_z z + W_p p + b)`` written as one MLP over ``concat(z, p)``:
z = the flattened embeddings and the dense features, p = the inner products
of the field pairs i < j (IPNN, F(F-1)/2 values, ``pnn_inner_products``),
the superposed outer product ``s s^T`` (OPNN, D^2 values,
``pnn_outer_product``), or both (``mode``). One ``emb`` collection of dim D:
no first-order weights, so no fused column.

Dtypes as in the JAX package: the products are in the rows' dtype, and the
MLP takes its input in ``compute_dtype`` and returns f32.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

from recmodels_tpu_torch.data.schema import Schema
from recmodels_tpu_torch.models.base import CTRModel, EmbActivations, flatten_slots
from recmodels_tpu_torch.nn.mlp import mlp_apply, mlp_init
from recmodels_tpu_torch.ops.dispatch import get_op

MODES = ("inner", "outer", "both")


class PNNModel(CTRModel):
    name = "pnn"

    def __init__(self, schema: Schema, mode: str = "inner", hidden: Sequence[int] = (400, 400),
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(schema)
        if mode not in MODES:
            raise ValueError(f"bad PNN mode: {mode}")
        self.mode = mode
        self.hidden = tuple(hidden)
        self.compute_dtype = compute_dtype

    def embedding_schemas(self) -> Dict[str, Schema]:
        return {"emb": self.schema}

    def _product_width(self) -> int:
        f, d = self.schema.n_slots, self.schema.max_dim
        w = 0
        if self.mode in ("inner", "both"):
            w += f * (f - 1) // 2
        if self.mode in ("outer", "both"):
            w += d * d
        return w

    def init_dense(self, generator: torch.Generator, device):
        """The JAX package's distributions (its draws differ: weights carried
        across go through ``serve.params_from_jax``)."""
        in_dim = self.schema.n_slots * self.schema.max_dim + self.schema.n_dense + self._product_width()
        return {"mlp": mlp_init(generator, in_dim, self.hidden, out_dim=1, device=device)}

    def apply(self, params, dense: torch.Tensor, emb: EmbActivations) -> torch.Tensor:
        e = emb["emb"]
        feats = [flatten_slots(e), dense.to(e.dtype)]
        if self.mode in ("inner", "both"):
            feats.append(get_op("pnn_inner_products")(e))
        if self.mode in ("outer", "both"):
            feats.append(get_op("pnn_outer_product")(e).reshape(e.shape[0], -1))
        h = torch.cat(feats, dim=1)
        return mlp_apply(params["mlp"], h, final_linear=True, compute_dtype=self.compute_dtype)[:, 0]
