"""FM — second-order factorization machine (Rendle 2010); port of
``recmodels_tpu/models/fm.py``.

``logit = b + sum_i w[c_i] + w_d . x + 1/2 sum_d [(sum_i e_i)_d^2 - sum_i (e_i)_d^2]``
The pairwise term runs through ``ops.fm_pairwise`` (the CUDA kernel on the
card, the plain version on the CPU). FM computes in f32 throughout.
"""

from __future__ import annotations

from typing import Dict

import torch

from recmodels_tpu_torch.data.schema import Schema
from recmodels_tpu_torch.models.base import CTRModel, EmbActivations, wide_schema
from recmodels_tpu_torch.ops.dispatch import get_op


class FMModel(CTRModel):
    name = "fm"

    def embedding_schemas(self) -> Dict[str, Schema]:
        return {"wide": wide_schema(self.schema), "emb": self.schema}

    def init_dense(self, generator: torch.Generator, device):
        return {
            "w_dense": torch.zeros((self.schema.n_dense,), device=device),
            "bias": torch.zeros((), device=device),
        }

    def apply(self, params, dense: torch.Tensor, emb: EmbActivations) -> torch.Tensor:
        first = torch.sum(emb["wide"][..., 0], dim=1)
        second = get_op("fm_pairwise")(emb["emb"])
        return params["bias"] + first + dense @ params["w_dense"] + second
