"""NFM — Neural Factorization Machine (arXiv:1708.05027); port of
``recmodels_tpu/models/nfm.py``.

``logit = b + sum_i w[c_i] + w_d . x + MLP(bi_interaction(e))``: the FM
pairwise vector before its sum over dims (``ops.fm_bi_interaction``, [B, D])
through an MLP. The engine fuses the ``wide`` collection into the ``emb``
table as its last column.

Dtypes as in the JAX package: the bi-interaction is in the rows' dtype, the
MLP takes it in ``compute_dtype`` and returns f32, and the first-order sum
is f32.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

from recmodels_tpu_torch.data.schema import Schema
from recmodels_tpu_torch.models.base import CTRModel, EmbActivations, wide_schema
from recmodels_tpu_torch.nn.mlp import mlp_apply, mlp_init
from recmodels_tpu_torch.ops.interactions import fm_bi_interaction


class NFMModel(CTRModel):
    name = "nfm"

    def __init__(self, schema: Schema, hidden: Sequence[int] = (128, 128),
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(schema)
        self.hidden = tuple(hidden)
        self.compute_dtype = compute_dtype

    def embedding_schemas(self) -> Dict[str, Schema]:
        return {"wide": wide_schema(self.schema), "emb": self.schema}

    def init_dense(self, generator: torch.Generator, device):
        """The JAX package's distributions (its draws differ: weights carried
        across go through ``serve.params_from_jax``)."""
        return {
            "mlp": mlp_init(generator, self.schema.max_dim, self.hidden, out_dim=1, device=device),
            "w_dense": torch.zeros((self.schema.n_dense,), device=device),
            "bias": torch.zeros((), device=device),
        }

    def apply(self, params, dense: torch.Tensor, emb: EmbActivations) -> torch.Tensor:
        bi = fm_bi_interaction(emb["emb"])  # [B, D]
        y_mlp = mlp_apply(params["mlp"], bi, final_linear=True, compute_dtype=self.compute_dtype)[:, 0]
        first = torch.sum(emb["wide"][..., 0], dim=1)
        return params["bias"] + first + dense @ params["w_dense"] + y_mlp
