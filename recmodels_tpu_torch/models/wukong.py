"""Wukong: a stack of identical interaction layers of Factorization Machine
Blocks and Linear Compress Blocks ("Wukong: Towards a Scaling Law for
Large-Scale Recommendation", Zhang et al., ICML 2024, arXiv:2403.02545 §3).
The port's own: the JAX package has no such model.

Its slots are sum-pooled bags, as DLRM-DCNv2's (``FeatureSpec.hotness``; the
engine pools them before the model, ``embedding/bag.py``):

* bottom MLP on the dense features, ReLU after every layer, its last width
  the embedding dim d;
* ``X_0 = [bottom(dense); e_1; ...; e_F]`` [B, n_0 = F + 1, d];
* ``n_layers`` layers, each over ``X`` [B, n, d] (``n = n_0`` at layer 1,
  ``n_F + n_L`` after):

      FM(X)   = X (X^T Y)                                [B, n, k]
      FMB(X)  = reshape(MLP_F(LN_F(flatten(FM(X)))))     [B, n_F, d]
      LCB(X)  = W_L X                                    [B, n_L, d]
      X'      = LN_d(concat(FMB(X), LCB(X)) + P X)       [B, n_F + n_L, d]

  with ``Y`` [n, k] learned (the optimised FM), ``MLP_F`` ``n k -> fmb_hidden
  -> n_F d`` with ReLU between layers and the last linear, ``LN_F`` over the
  example's n k values and ``LN_d`` over each embedding's d values (both
  with a scale and shift), and ``P`` the identity where ``n = n_F + n_L``,
  else a learned projection (layer 1: ``n_0 -> n_F + n_L``);
* the top MLP on ``flatten(X_l)``, ReLU on every layer but the last, whose
  one output is the logit.

Parameters, all f32, ``[in, out]`` as the MLPs' (``nn/mlp.py``): ``bottom``
and ``top`` MLP layers, and ``layers``, one dict a layer: ``fm_y`` ``Y`` [n,
k]; ``lcb`` ``W_L^T`` [n, n_L]; ``ln_f_scale``, ``ln_f_shift`` [n k] (in
``flatten(FM(X))``'s row-major order); ``mlp`` the MLP_F layers
(``{"w", "b"}``); ``ln_scale``, ``ln_shift`` [d]; and, where ``n != n_F +
n_L``, ``proj`` ``P^T`` [n, n_F + n_L]. Flatten order: ``bottom``,
``layers`` (each layer's keys sorted: ``fm_y``, ``lcb``, ``ln_f_scale``,
``ln_f_shift``, ``ln_scale``, ``ln_shift``, ``mlp``, ``proj``), ``top``.
``flatten`` is row-major everywhere: ``flatten(X_l)[j d + c] = X_l[j, c]``.

Rounding points, in ``compute_dtype`` c (bf16 on the card; f32 rounds
nowhere), every product's operands in c and its sum in f32 with one rounding
at its output: the MLPs' as ``nn/mlp.mlp_apply``; ``X_0`` the bottom's c
output beside the pooled rows in c; in each layer ``Z = c(X^T c(Y))``, ``F
= X Z`` (f32, not rounded), ``A = c(LN_F(F))`` (LN statistics in f32, the
f32 scale and shift), ``L = c(c(W_L) X)``, ``H = MLP_F(A)`` (c), ``R = X``
or ``c(c(P) X)``, ``S = c(concat(H, L) + R)`` (one rounding of the f32
sum), ``X' = c(LN_d(S))`` with f32 statistics and the f32 scale and shift
(``nn/wukong_ln.py``: one kernel for the sum and the LayerNorm); ``X_i``
are stored in c.

The stack's backward (``WukongStack``), layer by layer from the top, g the
cotangent of ``X_{i+1}`` in c: ``LN_d``'s backward (``nn/wukong_ln``)
gives ``g_S`` (c, its f32 form rounded once), its rows ``g_H = g_S[:,
:n_F]`` as one contiguous [B, n_F d] and the f32 grads of its scale and
shift; ``g_H`` runs MLP_F's backward (``nn/mlp.stack_backward``: ``g_A`` in c, its
weights' grads as ``MlpStack``'s); the residual's cotangent ``g_R = g_S``, or
``c(c(P)^T g_S)`` with ``g_P = sum_b X g_S^T`` in f32; then the FM kernels'
backward (``nn/wukong_fm.fm_backward``) takes ``g_A``, ``g_L = g_S[:,
n_F:]`` and ``g_R`` and gives ``X``'s cotangent ``c(g_X^FM + g_X^LCB +
g_R)`` (one rounding) and the f32 grads of ``Y``, ``W_L`` and LN_F's scale
and shift, batch sums in a fixed order. Saved a layer: ``X`` (c), LN_F's
mean and rstd, MLP_F's layer inputs ``A`` and its hidden ``H_1`` (c), ``S``
(c) and LN_d's statistics, some 22 KB an example at the cell's widths; the
kernels compute ``Z`` and ``F`` again from ``X`` rather than save them.

Tracing: the span ``model.wukong`` over the stack, ``model.wukong.fm`` over
each layer's FM call (forward and backward), and the counter
``wukong.fm_layers``: the layers routed through the FM kernels, added at
each forward that runs them (eager or at capture, not on replays).
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

import torch

from recmodels_tpu_torch.data.schema import Schema
from recmodels_tpu_torch.models.base import CTRModel, EmbActivations
from recmodels_tpu_torch.nn.mlp import _mm_f32, _stack_forward, mlp_apply, mlp_init, stack_backward
from recmodels_tpu_torch.nn.wukong_fm import fm_backward, fm_forward, kernel_route
from recmodels_tpu_torch.nn.wukong_ln import residual_ln_backward, residual_ln_forward
from recmodels_tpu_torch.utils import profiling
from recmodels_tpu_torch.utils.profiling import annotate

LN_EPS = 1e-5  # both LayerNorms' (PyTorch's default)
_CAST = ("fm_y", "lcb", "proj")  # rounded to c where they enter a product
_F32 = ("ln_f_scale", "ln_f_shift", "ln_scale", "ln_shift")  # read by the LayerNorms in f32


def wukong_init(generator: torch.Generator, n_in: int, n_fmb: int, n_lcb: int, fm_rank: int, d: int,
                fmb_hidden: Sequence[int], n_layers: int, device) -> list:
    """``n_layers`` layers: ``Y``, ``W_L^T`` and ``P^T`` N(0, 1/n) (Xavier's
    fan-in scale), the LayerNorms' scales 1 and shifts 0, MLP_F as
    ``nn/mlp.mlp_init`` (He; its last, linear layer 1/in)."""
    n_out = n_fmb + n_lcb
    layers = []
    for i in range(n_layers):
        n = n_in if i == 0 else n_out

        def randn(*shape):
            return torch.randn(shape, generator=generator, device=device, dtype=torch.float32) / math.sqrt(n)

        layer = {"fm_y": randn(n, fm_rank), "lcb": randn(n, n_lcb),
                 "ln_f_scale": torch.ones((n * fm_rank,), device=device),
                 "ln_f_shift": torch.zeros((n * fm_rank,), device=device),
                 "mlp": mlp_init(generator, n * fm_rank, fmb_hidden, out_dim=n_fmb * d, device=device),
                 "ln_scale": torch.ones((d,), device=device), "ln_shift": torch.zeros((d,), device=device)}
        if n != n_out:
            layer["proj"] = randn(n, n_out)
        layers.append(layer)
    return layers


def _layer_leaves(layer: dict) -> list:
    """A layer's tensors in the order ``WukongStack`` takes them: the keys
    of ``_CAST`` and ``_F32`` the layer has, then MLP_F's ``w``, ``b``."""
    out = [layer[k] for k in (*_CAST, *_F32) if k in layer]
    return out + [t for mlp in layer["mlp"] for t in (mlp["w"], mlp["b"])]


def _left(p: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``p @ x[b]`` for each b: ``p`` [m, n] and ``x`` [B, n, d] in c, the
    sum in f32 rounded once to c (the CPU widens the operands to f32)."""
    if x.device.type == "cpu":
        return torch.matmul(p.float(), x.float()).to(x.dtype)
    return torch.matmul(p, x)


def _outer_sum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``sum_b a[b] b[b]^T`` in f32 of ``a`` [B, n, d] and ``b`` [B, m, d]:
    one product over the batch's rows, [n, B d] by [B d, m]."""
    a2 = a.transpose(0, 1).reshape(a.shape[1], -1)
    b2 = b.transpose(0, 1).reshape(b.shape[1], -1)
    return _mm_f32(a2, b2.t()) if a.dtype == torch.bfloat16 else a2.float() @ b2.float().t()


class _Layer:
    """One layer's weights as the stack uses them: ``_CAST``'s in c, the
    rest as they are."""

    def __init__(self, leaves, keys, n_mlp: int, c: torch.dtype):
        named = dict(zip(keys, leaves[:len(keys)]))
        for k in _CAST:
            if k in named:
                named[k] = named[k].to(c)
        self.y, self.lcb, self.proj = named["fm_y"], named["lcb"], named.get("proj")
        self.ln_scale, self.ln_shift = named["ln_scale"], named["ln_shift"]
        self.ln_f_scale, self.ln_f_shift = named["ln_f_scale"], named["ln_f_shift"]
        mlp = leaves[len(keys):len(keys) + 2 * n_mlp]
        self.ws = [w.to(c) for w in mlp[0::2]]
        self.bs = list(mlp[1::2])

    def saved(self) -> list:
        """What the backward reads of the weights (``proj`` last, where the
        layer has one)."""
        return [self.y, self.lcb, self.ln_scale, self.ln_f_scale, *self.ws] + (
            [] if self.proj is None else [self.proj])


def _layers(layout, leaves, c: torch.dtype) -> list:
    out, i = [], 0
    for keys, n_mlp in layout:
        out.append(_Layer(leaves[i:], keys, n_mlp, c))
        i += len(keys) + 2 * n_mlp
    return out


def _forward_layer(lw: _Layer, x: torch.Tensor):
    """``X'`` of one layer and what its backward reads of the activations:
    (X, LN_F's mean and rstd, MLP_F's layer inputs..., S, LN_d's mean and
    rstd)."""
    with annotate("model.wukong.fm"):
        a, l, mean_f, rstd_f = fm_forward(x, lw.y, lw.lcb, lw.ln_f_scale, lw.ln_f_shift, LN_EPS)
    hs = _stack_forward(True, a, lw.ws, lw.bs)
    r = x if lw.proj is None else _left(lw.proj.t(), x)
    s, out, mean_d, rstd_d = residual_ln_forward(hs[-1], l, r, lw.ln_scale, lw.ln_shift, LN_EPS)
    return out, [x, mean_f, rstd_f, *hs[:-1], s, mean_d, rstd_d]


def _backward_layer(saved: list, n_mlp: int, n_fmb: int, g: torch.Tensor):
    """One layer's backward from the cotangent ``g`` of its output: (X's
    cotangent, {leaf key: f32 grad}, MLP_F's grads [g_w_0, g_b_0, ...])."""
    x, mean_f, rstd_f, *hs, s, mean_d, rstd_d = saved[:6 + n_mlp]
    y, lcb, ln_scale, ln_f_scale, *rest = saved[6 + n_mlp:]
    ws, proj = rest[:n_mlp], (rest[n_mlp] if len(rest) > n_mlp else None)
    g_s, g_h, g_ln_scale, g_ln_shift = residual_ln_backward(g, s, mean_d, rstd_d, ln_scale, n_fmb)
    g_a, mlp_grads = stack_backward(True, hs, ws, g_h)
    g_res, g_proj = (g_s, None) if proj is None else (_left(proj, g_s).contiguous(), _outer_sum(x, g_s))
    with annotate("model.wukong.fm"):
        g_x, g_y, g_lcb, g_f_scale, g_f_shift = fm_backward(x, y, lcb, ln_f_scale, mean_f, rstd_f, g_a, g_s,
                                                            n_fmb, g_res)
    named = {"fm_y": g_y, "lcb": g_lcb, "ln_scale": g_ln_scale, "ln_shift": g_ln_shift, "proj": g_proj,
             "ln_f_scale": g_f_scale, "ln_f_shift": g_f_shift}
    return g_x, named, mlp_grads


class WukongStack(torch.autograd.Function):
    """The Wukong layers: ``forward(layout, n_fmb, x0, *leaves)`` -> ``X_l``
    in x0's dtype c, ``layout`` a (leaf keys, MLP_F layers) pair a layer and
    ``leaves`` each layer's ``_layer_leaves``; the backward of the module
    docstring, every leaf's grad in f32."""

    @staticmethod
    def forward(ctx, layout, n_fmb: int, x0, *leaves):
        x, saved = x0, []
        for lw in _layers(layout, leaves, x0.dtype):
            x, keep = _forward_layer(lw, x)
            saved.append(keep + lw.saved())
        ctx.layout, ctx.n_fmb, ctx.counts = layout, n_fmb, [len(k) for k in saved]
        ctx.save_for_backward(*(t for k in saved for t in k))
        return x

    @staticmethod
    def backward(ctx, g):
        flat, per_layer, i = ctx.saved_tensors, [], 0
        for k in ctx.counts:
            per_layer.append(flat[i:i + k])
            i += k
        grads = []
        g = g.contiguous()
        for saved, (keys, n_mlp) in reversed(list(zip(per_layer, ctx.layout))):
            g, named, mlp_grads = _backward_layer(list(saved), n_mlp, ctx.n_fmb, g)
            grads = [named[k].float() for k in keys] + [t.float() for t in mlp_grads] + grads
        return (None, None, g, *grads)


def wukong_apply(layers: list, x0: torch.Tensor, n_fmb: int) -> torch.Tensor:
    """``X_l`` [B, n_F + n_L, d] of the Wukong layers ``layers`` on ``x0``
    [B, n_0, d], in x0's dtype (the rounding points of the module
    docstring)."""
    layout = tuple((tuple(k for k in (*_CAST, *_F32) if k in layer), len(layer["mlp"])) for layer in layers)
    leaves = [t for layer in layers for t in _layer_leaves(layer)]
    if kernel_route(x0):
        profiling.count("wukong.fm_layers", len(layers))
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x0, *leaves)):
        return WukongStack.apply(layout, n_fmb, x0, *leaves)
    x = x0
    for lw in _layers(layout, leaves, x0.dtype):
        x = _forward_layer(lw, x)[0]
    return x


class WukongModel(CTRModel):
    name = "wukong"

    def __init__(
        self,
        schema: Schema,
        bottom: Sequence[int] = (512, 256, 128),
        top: Sequence[int] = (1024, 1024, 512, 256),
        n_layers: int = 8,
        n_fmb: int = 16,
        n_lcb: int = 16,
        fm_rank: int = 32,
        fmb_hidden: Sequence[int] = (2048,),
        compute_dtype: torch.dtype = torch.float32,
    ):
        super().__init__(schema)
        if not schema.uniform_dim:
            raise ValueError("wukong stacks the pooled rows: every slot needs one embedding dim")
        if not bottom or bottom[-1] != schema.max_dim:
            raise ValueError(f"wukong: the bottom MLP's last width ({bottom[-1] if bottom else None}) must "
                             f"equal the embedding dim ({schema.max_dim})")
        if min(n_layers, n_fmb, n_lcb, fm_rank) < 1:
            raise ValueError(f"wukong: n_layers {n_layers}, n_fmb {n_fmb}, n_lcb {n_lcb} and fm_rank {fm_rank} "
                             f"must be at least 1")
        self.bottom = tuple(bottom)
        self.top = tuple(top)
        self.n_layers, self.n_fmb, self.n_lcb, self.fm_rank = n_layers, n_fmb, n_lcb, fm_rank
        self.fmb_hidden = tuple(fmb_hidden)
        self.compute_dtype = compute_dtype

    def embedding_schemas(self) -> Dict[str, Schema]:
        return {"emb": self.schema}

    @property
    def n_in(self) -> int:
        """Embeddings into layer 1: the bottom's and one a slot."""
        return self.schema.n_slots + 1

    def init_dense(self, generator: torch.Generator, device):
        """The MLPs as ``nn/mlp.mlp_init`` (He; the logit's layer 1/in), the
        layers as ``wukong_init``."""
        d = self.schema.max_dim
        return {"bottom": mlp_init(generator, self.schema.n_dense, self.bottom, device=device),
                "layers": wukong_init(generator, self.n_in, self.n_fmb, self.n_lcb, self.fm_rank, d,
                                      self.fmb_hidden, self.n_layers, device),
                "top": mlp_init(generator, (self.n_fmb + self.n_lcb) * d, self.top, out_dim=1, device=device)}

    def apply(self, params, dense: torch.Tensor, emb: EmbActivations) -> torch.Tensor:
        c = self.compute_dtype
        e = emb["emb"].to(c)
        bottom = mlp_apply(params["bottom"], dense, final_linear=False, compute_dtype=c)
        x0 = torch.cat([bottom.to(c)[:, None, :], e], dim=1)
        with annotate("model.wukong"):
            xl = wukong_apply(params["layers"], x0, self.n_fmb)
        return mlp_apply(params["top"], xl.reshape(xl.shape[0], -1), final_linear=True, compute_dtype=c)[:, 0]
