"""The plain f32 Wukong the check holds the program to, and its first training
steps (imports torch alone: nothing of the program, of JAX or of the JAX
package).

Wukong ("Wukong: Towards a Scaling Law for Large-Scale Recommendation",
arXiv:2403.02545 §3) over MLPerf DLRM-DCNv2's inputs (sum-pooled bags of
128-wide rows and the bottom MLP, ``dlrm_dcnv2.py``):

    X_0     = [bottom(dense); e_1; ...; e_26]                [B, 27, d]
    FM(X)   = X (X^T Y)                                       [B, n, k]
    FMB(X)  = reshape(MLP_F(LN_F(flatten(FM(X)))))           [B, n_F, d]
    LCB(X)  = W_L X                                           [B, n_L, d]
    X'      = LN_d(concat(FMB(X), LCB(X)) + P X)             [B, n_F + n_L, d]
    logit   = top(flatten(X_l))

``LN_F`` normalises the n k values of an example, ``LN_d`` each embedding's
d values, both with a scale and shift and eps 1e-5; ``MLP_F`` is ReLU
between its layers and linear last; ``P`` is the identity where n = n_F +
n_L, else learned (layer 1). Departures from the paper, which leaves these
open: Y a free parameter, LN_F over the example's n k values, MLP_F's last
layer linear, P only at layer 1. Loss, optimizers and table as
``dlrm_dcnv2.py``'s: BCE's batch mean, dense Adagrad (optax's form, eps
1e-7) and per-element Adagrad on the rows (eps 1e-8), accumulators from 0.1.

Weights are ``[in, out]``: ``layers.i.fm_y`` is Y [n, k], ``layers.i.lcb``
W_L^T [n, n_L], ``layers.i.proj`` P^T [n, n_F + n_L], ``layers.i.mlp.j.w``
[in, out]; names as the program flattens them.

``q`` is a rounding applied where a lower-precision program would round
(``precision.py``): the identity for the reference, fp8 for the control; as
in the program, the LayerNorms' scales and shifts are not rounded.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference.dlrm_dcnv2 import DenseAdagrad, f32_products, mlp, norms, pooled, table_leaves
from benchmark.reference.optim import RowAdagrad
from benchmark.reference.precision import rounding

EPS = 1e-5


def widths(cfg: dict, layer: int) -> int:
    """Embeddings into layer ``layer``."""
    return cfg["n_slots"] + 1 if layer == 0 else cfg["n_fmb"] + cfg["n_lcb"]


def init(cfg: dict, randn) -> dict:
    """Every parameter but the table, by name, all live: the MLPs He (the
    logit's layer 1/in), Y, W_L and P N(0, 1/n), LN scales 1 + N(0, 0.01),
    LN shifts and every bias N(0, 0.01). ``randn(*shape, std=)`` draws
    them."""
    out = {}
    d, k, m = cfg["embed_dim"], cfg["fm_rank"], cfg["n_fmb"] + cfg["n_lcb"]

    def mlp_init(name, sizes, last_linear):
        for j, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
            last = last_linear and j == len(sizes) - 2
            out[f"{name}.{j}.b"] = randn(b, std=0.01)
            out[f"{name}.{j}.w"] = randn(a, b, std=((1.0 if last else 2.0) / a) ** 0.5)

    mlp_init("bottom", [cfg["n_dense"], *cfg["bottom"]], False)
    for i in range(cfg["n_layers"]):
        n, p = widths(cfg, i), f"layers.{i}"
        out[f"{p}.fm_y"] = randn(n, k, std=n ** -0.5)
        out[f"{p}.lcb"] = randn(n, cfg["n_lcb"], std=n ** -0.5)
        out[f"{p}.ln_f_scale"] = 1.0 + randn(n * k, std=0.01)
        out[f"{p}.ln_f_shift"] = randn(n * k, std=0.01)
        mlp_init(f"{p}.mlp", [n * k, *cfg["fmb_hidden"], cfg["n_fmb"] * d], True)
        out[f"{p}.ln_scale"] = 1.0 + randn(d, std=0.01)
        out[f"{p}.ln_shift"] = randn(d, std=0.01)
        if n != m:
            out[f"{p}.proj"] = randn(n, m, std=n ** -0.5)
    mlp_init("top", [m * d, *cfg["top"], 1], True)
    return out


def layer(cfg: dict, params: dict, i: int, x: torch.Tensor, q) -> torch.Tensor:
    b, _, d = x.shape
    p = f"layers.{i}"
    z = q(x.transpose(1, 2) @ q(params[f"{p}.fm_y"]))
    f = (x @ z).reshape(b, -1)
    a = q(F.layer_norm(f, (f.shape[1],), params[f"{p}.ln_f_scale"], params[f"{p}.ln_f_shift"], EPS))
    h = mlp(a, params, f"{p}.mlp", len(cfg["fmb_hidden"]) + 1, True, q).reshape(b, cfg["n_fmb"], d)
    lcb = q(q(params[f"{p}.lcb"]).t() @ x)
    r = x if f"{p}.proj" not in params else q(q(params[f"{p}.proj"]).t() @ x)
    s = q(torch.cat([h, lcb], dim=1) + r)
    return q(F.layer_norm(s, (d,), params[f"{p}.ln_scale"], params[f"{p}.ln_shift"], EPS))


def logits(cfg: dict, params: dict, rows: torch.Tensor, idx: torch.Tensor, dense: torch.Tensor, q) -> torch.Tensor:
    """The logits [B] of examples whose ids are positions ``idx`` in the
    table rows ``rows``."""
    e = q(pooled(rows, idx, cfg["hotness"]))
    x = torch.cat([mlp(dense, params, "bottom", len(cfg["bottom"]), False, q)[:, None, :], e], dim=1)
    for i in range(cfg["n_layers"]):
        x = layer(cfg, params, i, x, q)
    return mlp(x.reshape(x.shape[0], -1), params, "top", len(cfg["top"]) + 1, True, q)[:, 0]


def readings(cfg: dict, dense_params: dict, rows0: torch.Tensor, idx: torch.Tensor, dense: torch.Tensor,
             labels: torch.Tensor, precision: str = "f32", block: int = 1024) -> dict:
    """Steps on K batches, as ``dlrm_dcnv2.readings``: ``dense_params`` by
    name; ``rows0`` [U, D] the initial rows the batches touch; ``idx`` [K, B,
    n_ids] each id's position in ``rows0``; ``dense`` [K, B, n_dense];
    ``labels`` [K, B]. Returns the losses, the first gradient's norms
    (``grad``), the dense leaves' first gradient (``grad_vec``), the rows'
    (``grad_table`` [U, D]) and each leaf's change over the K steps
    (``change``). Batches run in blocks of ``block`` examples, their grads
    summed."""
    f32_products()
    q = rounding(precision)
    params = {k: v.detach().clone().float().requires_grad_(True) for k, v in dense_params.items()}
    start = {k: v.detach().clone() for k, v in params.items()}
    rows = rows0.detach().clone().float().requires_grad_(True)
    dense_opt = DenseAdagrad(params, cfg["dense_lr"], cfg["initial_accumulator"])
    table_opt = RowAdagrad(rows, cfg["emb_lr"], cfg["initial_accumulator"])
    out = {"loss": [], "grad": None, "grad_vec": None, "grad_table": None, "change": None}
    k_steps, b = idx.shape[:2]
    for k in range(k_steps):
        for p in (*params.values(), rows):
            p.grad = None
        loss = 0.0
        for s in range(0, b, block):
            sl = slice(s, min(b, s + block))
            z = logits(cfg, params, rows, idx[k, sl], q(dense[k, sl]), q)
            part = F.binary_cross_entropy_with_logits(z, labels[k, sl], reduction="sum") / b
            part.backward()
            loss += float(part.detach().double())
        out["loss"].append(loss)
        grads = {n: p.grad for n, p in params.items()}
        if k == 0:
            out["grad"] = norms({**grads, **table_leaves(rows.grad)})
            out["grad_vec"] = {n: g.detach().clone() for n, g in grads.items()}
            out["grad_table"] = rows.grad.detach().clone()
        dense_opt.step(params, grads)
        table_opt.step(rows.data, rows.grad)
    with torch.no_grad():
        out["change"] = norms({**{n: p - start[n] for n, p in params.items()}, **table_leaves(rows - rows0)})
    return out
