"""Wide & Deep (arXiv:1606.07792); port of ``recmodels_tpu/models/widedeep.py``.

A wide linear part (the first-order weights of the dim-1 ``wide``
collection and a dense linear term) plus a deep MLP over the embeddings and
the dense features. The engine fuses ``wide`` into the ``emb`` table as its
last column and hands the model the two views of the gathered rows.

Dtypes as in the JAX package: the first-order sum is f32 (the engine
upcasts the wide activation); the MLP takes the rows and the dense features
in ``compute_dtype`` and returns f32.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

from recmodels_tpu_torch.data.schema import Schema
from recmodels_tpu_torch.models.base import CTRModel, EmbActivations, flatten_slots, wide_schema
from recmodels_tpu_torch.nn.mlp import mlp_apply, mlp_init


class WideDeepModel(CTRModel):
    name = "widedeep"

    def __init__(self, schema: Schema, hidden: Sequence[int] = (256, 128),
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(schema)
        self.hidden = tuple(hidden)
        self.compute_dtype = compute_dtype

    def embedding_schemas(self) -> Dict[str, Schema]:
        return {"wide": wide_schema(self.schema), "emb": self.schema}

    def init_dense(self, generator: torch.Generator, device):
        """The JAX package's distributions (its draws differ: weights carried
        across go through ``serve.params_from_jax``)."""
        in_dim = self.schema.n_slots * self.schema.max_dim + self.schema.n_dense
        return {
            "mlp": mlp_init(generator, in_dim, self.hidden, out_dim=1, device=device),
            "w_dense": torch.zeros((self.schema.n_dense,), device=device),
            "bias": torch.zeros((), device=device),
        }

    def apply(self, params, dense: torch.Tensor, emb: EmbActivations) -> torch.Tensor:
        y_wide = torch.sum(emb["wide"][..., 0], dim=1) + dense @ params["w_dense"]
        e = emb["emb"]
        h = torch.cat([flatten_slots(e), dense.to(e.dtype)], dim=1)
        y_deep = mlp_apply(params["mlp"], h, final_linear=True, compute_dtype=self.compute_dtype)[:, 0]
        return params["bias"] + y_wide + y_deep
