"""AFM — Attentional Factorization Machine (arXiv:1708.04617); port of
``recmodels_tpu/models/afm.py``.

``logit = b + sum_i w[c_i] + w_d . x + p^T sum_ij a_ij (e_i * e_j)`` with
attention ``a_ij = softmax_ij(h^T relu(W (e_i * e_j) + b_att))`` over the
F(F-1)/2 pairs (``ops.afm_pair_products``). The engine fuses the ``wide``
collection into the ``emb`` table as its last column.

Dtypes as in the JAX package: the [B, P, D] pair products and the [B, P, A]
attention tensors stay in ``compute_dtype`` (each product a ``compute_dtype``
matmul, summed in f32 and rounded once), the softmax runs in f32, and the
pooled vector joins the f32 terms as f32.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from recmodels_tpu_torch.data.schema import Schema
from recmodels_tpu_torch.models.base import CTRModel, EmbActivations, wide_schema
from recmodels_tpu_torch.ops.interactions import afm_pair_products


class AFMModel(CTRModel):
    name = "afm"

    def __init__(self, schema: Schema, attention_dim: int = 32,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(schema)
        self.attention_dim = attention_dim
        self.compute_dtype = compute_dtype

    def embedding_schemas(self) -> Dict[str, Schema]:
        return {"wide": wide_schema(self.schema), "emb": self.schema}

    def init_dense(self, generator: torch.Generator, device):
        """The JAX package's distributions (its draws differ: weights carried
        across go through ``serve.params_from_jax``)."""
        d, a = self.schema.max_dim, self.attention_dim

        def randn(*shape):
            return torch.randn(shape, generator=generator, device=device, dtype=torch.float32)

        return {
            "w_att": randn(d, a) * math.sqrt(2.0 / d),
            "b_att": torch.zeros((a,), device=device),
            "h_att": randn(a) / math.sqrt(a),
            "p": randn(d) / math.sqrt(d),
            "w_dense": torch.zeros((self.schema.n_dense,), device=device),
            "bias": torch.zeros((), device=device),
        }

    def apply(self, params, dense: torch.Tensor, emb: EmbActivations) -> torch.Tensor:
        cd = self.compute_dtype
        pp = afm_pair_products(emb["emb"]).to(cd)  # [B, P, D]
        att_h = torch.relu(torch.matmul(pp, params["w_att"].to(cd)) + params["b_att"].to(cd))
        scores = torch.matmul(att_h, params["h_att"].to(cd))  # [B, P]
        a = torch.softmax(scores.float(), dim=1)
        pooled = torch.matmul(a.to(cd)[:, None, :], pp)[:, 0]  # [B, D]
        y_att = pooled.float() @ params["p"]
        first = torch.sum(emb["wide"][..., 0], dim=1)
        return params["bias"] + first + dense @ params["w_dense"] + y_att
