"""DCN — Deep & Cross network (arXiv:1708.05123); port of
``recmodels_tpu/models/dcn.py``.

``x0 = concat(e_1..e_F, x_dense)``; cross layer
``x_{l+1} = x0 (x_l^T w_l) + b_l + x_l`` stacked L times (one launch of the
cross-stack kernel on the card), a parallel deep MLP on x0, and
``logit = w_out^T concat(x_L, h_deep) + bias``.

Dtypes as in the JAX package: x0 is in the rows' dtype and the cross
weights are cast to it; x_L (in that dtype) joins the MLP's f32 output as
f32.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

import torch

from recmodels_tpu_torch.data.schema import Schema
from recmodels_tpu_torch.models.base import CTRModel, EmbActivations, flatten_slots
from recmodels_tpu_torch.nn.mlp import mlp_apply, mlp_init
from recmodels_tpu_torch.ops.dispatch import get_op


class DCNModel(CTRModel):
    name = "dcn"

    def __init__(
        self,
        schema: Schema,
        n_cross: int = 3,
        hidden: Sequence[int] = (512, 256),
        compute_dtype: torch.dtype = torch.float32,
    ):
        super().__init__(schema)
        self.n_cross = n_cross
        self.hidden = tuple(hidden)
        self.compute_dtype = compute_dtype

    def embedding_schemas(self) -> Dict[str, Schema]:
        return {"emb": self.schema}

    @property
    def x0_dim(self) -> int:
        return self.schema.n_slots * self.schema.max_dim + self.schema.n_dense

    def init_dense(self, generator: torch.Generator, device):
        """The JAX package's distributions (its draws differ: weights carried
        across go through ``serve.params_from_jax``). Flatten order: bias,
        cross/b, cross/w, mlp/*, w_out."""
        d = self.x0_dim

        def randn(*shape):
            return torch.randn(shape, generator=generator, device=device, dtype=torch.float32)

        cross = {"w": randn(self.n_cross, d) / math.sqrt(d),
                 "b": torch.zeros((self.n_cross, d), device=device)}
        mlp = mlp_init(generator, d, self.hidden, device=device)
        out_dim = d + (self.hidden[-1] if self.hidden else 0)
        return {"cross": cross, "mlp": mlp, "w_out": randn(out_dim) / math.sqrt(out_dim),
                "bias": torch.zeros((), device=device)}

    def apply(self, params, dense: torch.Tensor, emb: EmbActivations) -> torch.Tensor:
        e = emb["emb"]
        x0 = torch.cat([flatten_slots(e), dense.to(e.dtype)], dim=1)
        xl = get_op("dcn_cross_stack")(
            x0, params["cross"]["w"].to(x0.dtype), params["cross"]["b"].to(x0.dtype)
        )
        parts = [xl.float()]
        if self.hidden:
            parts.append(mlp_apply(params["mlp"], x0, final_linear=False,
                                   compute_dtype=self.compute_dtype))
        h = torch.cat(parts, dim=1)
        return h @ params["w_out"] + params["bias"]
