"""LR — sparse logistic regression; port of ``recmodels_tpu/models/lr.py``.

``logit = b + sum_i w[c_i] + w_d . x_dense``: one scalar weight per hash
bucket (the dim-1 ``wide`` collection, its only table: the engine fuses
nothing, gathers its rows in f32 and updates them with the dim-1 sparse
update) plus a dense linear term. LR computes in f32 only.
"""

from __future__ import annotations

from typing import Dict

import torch

from recmodels_tpu_torch.data.schema import Schema
from recmodels_tpu_torch.models.base import CTRModel, EmbActivations, wide_schema


class LRModel(CTRModel):
    name = "lr"

    def embedding_schemas(self) -> Dict[str, Schema]:
        return {"wide": wide_schema(self.schema)}

    def init_dense(self, generator: torch.Generator, device):
        return {
            "w_dense": torch.zeros((self.schema.n_dense,), device=device),
            "bias": torch.zeros((), device=device),
        }

    def apply(self, params, dense: torch.Tensor, emb: EmbActivations) -> torch.Tensor:
        return params["bias"] + torch.sum(emb["wide"][..., 0], dim=1) + dense @ params["w_dense"]
