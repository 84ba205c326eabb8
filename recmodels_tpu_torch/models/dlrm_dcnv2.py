"""DLRM-DCNv2: MLPerf Training's recommendation model (DLRM, arXiv:1906.00091,
with the low-rank cross network of DCN-V2, arXiv:2008.13535 eq. 1-2; the
reference is TorchRec's ``DLRM_DCN`` with ``LowRankCrossNet``). The port's
own: the JAX package has no such model.

Its slots are sum-pooled bags (``FeatureSpec.hotness``; the engine pools
them before the model, ``embedding/bag.py``), one ``[B, n_slots, D]`` input:

* bottom MLP on the dense features, ReLU after every layer, its last width
  the embedding dim D;
* ``x0 = concat(bottom(dense), e_1, ..., e_F)``, ``[B, (F + 1) D]``;
* ``n_cross`` low-rank cross layers ``x_{l+1} = x0 * ((x_l V_l^T) W_l^T +
  b_l) + x_l`` (``V_l`` [r, (F + 1) D], ``W_l`` [(F + 1) D, r]);
* the top MLP on ``x_L``, ReLU on every layer but the last, whose one output
  is the logit.

Parameters are stored as the MLPs' (``nn/mlp.py``): ``[in, out]``, so a
cross layer holds ``v`` = ``V_l^T`` [(F + 1) D, r], ``w`` = ``W_l^T`` [r,
(F + 1) D] and ``b`` [(F + 1) D], all f32. Flatten order: ``bottom``,
``cross`` (each layer's ``b``, ``v``, ``w``), ``top``.

Rounding points, in ``compute_dtype`` c (bf16 on the card; f32 rounds
nowhere): the MLPs' as ``nn/mlp.mlp_apply`` (operands in c, products summed
in f32, the f32 bias added, ReLU, each layer's output rounded to c, the
logit too); ``x0`` is the bottom's c output beside the pooled rows in c (a
bag's sum is f32, rounded once by the bag gather); in each cross layer
``u = c(x_l V)`` (f32 sum, one rounding), ``t = c(u W + c(b))`` (f32 sum
with the bias rounded to c added, one rounding) and ``x_{l+1} = c(x0 * t +
x_l)`` (computed in f32, one rounding). The MLPs' backward is written out
in ``nn/mlp.MlpStack``; the cross stack's in ``LowRankCross``, layer by layer from the top, g the cotangent of
``x_{l+1}`` in c: ``g_t = c(g * x0)``; x0's cotangent accumulates ``c(acc +
g * t)``; the weights' grads are c products summed in f32 and kept in f32
(``g_W = u^T g_t``, ``g_V = x_l^T g_u``, ``g_b`` the f32 sum of ``g_t``);
``g_u = c(g_t W^T)``; and ``x_l``'s cotangent ``c(g + g_u V^T)``, the add
in the product's f32 sum (one rounding). Autograd would spend two more
elementwise passes a layer over ``[B, (F + 1) D]`` (the scale of
``addcmul``'s grads by its value 1, and the grads' accumulation).
Tracing: the span ``model.cross`` over the cross layers.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

import torch

from recmodels_tpu_torch.data.schema import Schema
from recmodels_tpu_torch.models.base import CTRModel, EmbActivations, flatten_slots
from recmodels_tpu_torch.nn.mlp import _mm_f32, mlp_apply, mlp_init
from recmodels_tpu_torch.utils.profiling import annotate


def cross_init(generator: torch.Generator, d: int, rank: int, n_cross: int, device) -> list:
    """``n_cross`` low-rank layers, TorchRec's init: ``V`` and ``W`` Xavier
    normal, ``b`` zero."""
    std = math.sqrt(2.0 / (d + rank))

    def randn(*shape):
        return torch.randn(shape, generator=generator, device=device, dtype=torch.float32) * std

    return [{"b": torch.zeros((d,), device=device), "v": randn(d, rank), "w": randn(rank, d)}
            for _ in range(n_cross)]


def _weight_grad(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` summed and returned in f32 (a weight's grad)."""
    return _mm_f32(a, b) if a.dtype == torch.bfloat16 else a @ b


class LowRankCross(torch.autograd.Function):
    """The low-rank cross stack: ``forward(x0, v_0, w_0, b_0, v_1, ...)``
    -> ``x_L`` in x0's dtype c, the f32 weights rounded to c; the backward
    of the module docstring, the weights' grads in f32."""

    @staticmethod
    def forward(ctx, x0, *weights):
        n = len(weights) // 3
        cast = [t.to(x0.dtype) for t in weights]
        xs, us, ts = [], [], []
        xl = x0
        for k in range(n):
            v, w, b = cast[3 * k:3 * k + 3]
            u = xl @ v
            t = torch.addmm(b, u, w)
            xs.append(xl)
            us.append(u)
            ts.append(t)
            xl = torch.addcmul(xl, x0, t)
        ctx.save_for_backward(x0, *cast, *xs, *us, *ts)
        ctx.n = n
        return xl

    @staticmethod
    def backward(ctx, g):
        n = ctx.n
        x0, *rest = ctx.saved_tensors
        cast, xs, us, ts = rest[:3 * n], rest[3 * n:4 * n], rest[4 * n:5 * n], rest[5 * n:]
        grads = [None] * (3 * n)
        g = g.to(x0.dtype)
        gx0 = None
        for k in reversed(range(n)):
            v, w, _ = cast[3 * k:3 * k + 3]
            gt = g * x0
            gx0 = g * ts[k] if gx0 is None else torch.addcmul(gx0, g, ts[k])
            gu = gt @ w.t()
            grads[3 * k] = _weight_grad(xs[k].t(), gu)
            grads[3 * k + 1] = _weight_grad(us[k].t(), gt)
            grads[3 * k + 2] = gt.sum(dim=0, dtype=torch.float32)
            g = torch.addmm(g, gu, v.t())
        return (gx0 + g, *grads)


def cross_apply(layers: list, x0: torch.Tensor) -> torch.Tensor:
    """``x_L`` of the low-rank cross stack on ``x0`` [B, d], in x0's dtype
    (the rounding points of the module docstring)."""
    return LowRankCross.apply(x0, *(layer[k] for layer in layers for k in ("v", "w", "b")))


class DLRMDCNv2Model(CTRModel):
    name = "dlrm_dcnv2"

    def __init__(
        self,
        schema: Schema,
        bottom: Sequence[int] = (512, 256, 128),
        top: Sequence[int] = (1024, 1024, 512, 256),
        n_cross: int = 3,
        low_rank: int = 512,
        compute_dtype: torch.dtype = torch.float32,
    ):
        super().__init__(schema)
        if not schema.uniform_dim:
            raise ValueError("dlrm_dcnv2 concatenates the pooled rows: every slot needs one embedding dim")
        if not bottom or bottom[-1] != schema.max_dim:
            raise ValueError(f"dlrm_dcnv2: the bottom MLP's last width ({bottom[-1] if bottom else None}) must "
                             f"equal the embedding dim ({schema.max_dim})")
        self.bottom = tuple(bottom)
        self.top = tuple(top)
        self.n_cross = n_cross
        self.low_rank = low_rank
        self.compute_dtype = compute_dtype

    def embedding_schemas(self) -> Dict[str, Schema]:
        return {"emb": self.schema}

    @property
    def x0_dim(self) -> int:
        return (self.schema.n_slots + 1) * self.schema.max_dim

    def init_dense(self, generator: torch.Generator, device):
        """The MLPs as ``nn/mlp.mlp_init`` (He; the logit's layer 1/in), the
        cross layers as ``cross_init``."""
        return {"bottom": mlp_init(generator, self.schema.n_dense, self.bottom, device=device),
                "cross": cross_init(generator, self.x0_dim, self.low_rank, self.n_cross, device),
                "top": mlp_init(generator, self.x0_dim, self.top, out_dim=1, device=device)}

    def apply(self, params, dense: torch.Tensor, emb: EmbActivations) -> torch.Tensor:
        c = self.compute_dtype
        e = emb["emb"].to(c)
        bottom = mlp_apply(params["bottom"], dense, final_linear=False, compute_dtype=c)
        x0 = torch.cat([bottom.to(c), flatten_slots(e)], dim=1)
        with annotate("model.cross"):
            xl = cross_apply(params["cross"], x0)
        return mlp_apply(params["top"], xl, final_linear=True, compute_dtype=c)[:, 0]
