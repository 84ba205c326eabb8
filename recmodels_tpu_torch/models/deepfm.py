"""DeepFM (arXiv:1703.04247); port of ``recmodels_tpu/models/deepfm.py``.

``y = sigmoid(y_FM + y_DNN)`` with the embedding tables shared between the
FM part and the DNN part: both read the same ``emb`` activations, so there
is one ``emb`` collection, one lookup and one sparse update.

Dtypes as in the JAX package: the first-order sum is f32 (the engine
upcasts the wide activation), the FM term is in the rows' dtype, and their
sum is f32; the MLP takes the rows and the dense features in
``compute_dtype`` and returns f32.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

from recmodels_tpu_torch.data.schema import Schema
from recmodels_tpu_torch.models.base import CTRModel, EmbActivations, flatten_slots, wide_schema
from recmodels_tpu_torch.nn.mlp import mlp_apply, mlp_init
from recmodels_tpu_torch.ops.dispatch import get_op


class DeepFMModel(CTRModel):
    name = "deepfm"

    def __init__(
        self,
        schema: Schema,
        hidden: Sequence[int] = (400, 400, 400),
        compute_dtype: torch.dtype = torch.float32,
    ):
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
        e = emb["emb"]
        y_fm = torch.sum(emb["wide"][..., 0], dim=1) + get_op("fm_pairwise")(e)
        h = torch.cat([flatten_slots(e), dense.to(e.dtype)], dim=1)
        y_dnn = mlp_apply(params["mlp"], h, final_linear=True, compute_dtype=self.compute_dtype)[:, 0]
        return params["bias"] + dense @ params["w_dense"] + y_fm + y_dnn
