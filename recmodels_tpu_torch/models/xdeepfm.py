"""xDeepFM — linear + CIN + DNN (arXiv:1803.05170); port of
``recmodels_tpu/models/xdeepfm.py``.

Field matrix X0 in R^{m x D}; CIN layer k:
``Xk_{h,d} = sum_{i,j} Wk_{h,i,j} (Xk-1_{i,d} * X0_{j,d})`` with per-layer sum
pooling over d; logit = linear + w_cin . concat(pools) + DNN + bias. CIN
weights are stored flat, ``[H_prev, m*H_next]`` (``ops.interactions``).

Products of f32 tensors (``dense @ w_dense``, ``p @ w_cin``, the MLP) run in
full f32: ``train.engine.Engine`` turns TF32 off for CUDA matmuls.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

import torch

from recmodels_tpu_torch.data.schema import Schema
from recmodels_tpu_torch.models.base import CTRModel, EmbActivations, flatten_slots, wide_schema
from recmodels_tpu_torch.nn.mlp import mlp_apply, mlp_init
from recmodels_tpu_torch.ops.dispatch import get_op
from recmodels_tpu_torch.ops.interactions import flatten_cin_w


class XDeepFMModel(CTRModel):
    name = "xdeepfm"

    def __init__(
        self,
        schema: Schema,
        cin_sizes: Sequence[int] = (128, 128),
        hidden: Sequence[int] = (400, 400),
        compute_dtype: torch.dtype = torch.float32,
    ):
        super().__init__(schema)
        self.cin_sizes = tuple(cin_sizes)
        self.hidden = tuple(hidden)
        self.compute_dtype = compute_dtype

    def embedding_schemas(self) -> Dict[str, Schema]:
        return {"wide": wide_schema(self.schema), "emb": self.schema}

    def init_dense(self, generator: torch.Generator, device):
        """The JAX package's distributions (its draws differ: weights carried
        across go through ``serve.params_from_jax``)."""
        m = self.schema.n_slots

        def randn(*shape):
            return torch.randn(shape, generator=generator, device=device, dtype=torch.float32)

        cin_w = []
        h_prev = m
        for h_next in self.cin_sizes:
            w = randn(h_next, h_prev, m) * math.sqrt(2.0 / (h_prev * m))
            cin_w.append(flatten_cin_w(w).contiguous())
            h_prev = h_next
        p_dim = sum(self.cin_sizes)
        in_dim = m * self.schema.max_dim + self.schema.n_dense
        return {
            "cin_w": cin_w,
            "w_cin": randn(p_dim) / math.sqrt(p_dim),
            "mlp": mlp_init(generator, in_dim, self.hidden, out_dim=1, device=device),
            "w_dense": torch.zeros((self.schema.n_dense,), device=device),
            "bias": torch.zeros((), device=device),
        }

    def _cin_ws(self, params, dtype):
        return [w.to(dtype) for w in params["cin_w"]]

    def apply_fused_rows(self, params, dense: torch.Tensor, full: torch.Tensor) -> torch.Tensor:
        """Forward from wide-fused rows [B, m, D+1] (the engine's path when
        it fuses the wide column). The MLP takes the D-major flattening of
        x_dm, a fixed feature order that differs from ``apply``'s."""
        b = full.shape[0]
        x_dm, wide_sum = get_op("split_fused_rows")(
            full.to(self.compute_dtype), self.schema.max_dim
        )
        p = get_op("cin_stack_dm_flat")(x_dm, self._cin_ws(params, self.compute_dtype)).float()
        y_lin = wide_sum + dense @ params["w_dense"]
        h = torch.cat([x_dm.reshape(b, -1), dense.to(x_dm.dtype)], dim=1)
        y_dnn = mlp_apply(params["mlp"], h, final_linear=True, compute_dtype=self.compute_dtype)[:, 0]
        return params["bias"] + y_lin + p @ params["w_cin"] + y_dnn

    def apply(self, params, dense: torch.Tensor, emb: EmbActivations) -> torch.Tensor:
        x0 = emb["emb"]  # [B, m, D]
        p = get_op("cin_stack_flat")(
            x0.to(self.compute_dtype), self._cin_ws(params, self.compute_dtype)
        ).float()
        y_lin = torch.sum(emb["wide"][..., 0], dim=1) + dense @ params["w_dense"]
        h = torch.cat([flatten_slots(x0), dense.to(x0.dtype)], dim=1)
        y_dnn = mlp_apply(params["mlp"], h, final_linear=True, compute_dtype=self.compute_dtype)[:, 0]
        return params["bias"] + y_lin + p @ params["w_cin"] + y_dnn
