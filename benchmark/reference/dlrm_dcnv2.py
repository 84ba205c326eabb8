"""The plain f32 DLRM-DCNv2 the check holds the program to, and its first
training steps (imports torch alone: nothing of the program, of JAX or of the
JAX package).

MLPerf Training's recommendation model (github.com/mlcommons/training,
recommendation_v2/torchrec_dlrm): DLRM (arXiv:1906.00091) with the low-rank
cross layers of DCN-V2 (arXiv:2008.13535 eq. 1-2), as TorchRec's
``DLRM_DCN`` and ``LowRankCrossNet``:

    e_s     = sum of the rows of slot s's bag of ids (sum pooling)
    x0      = concat(bottom(dense), e_1, ..., e_26)       [B, 27 D]
    x_{l+1} = x0 * ((x_l V_l^T) W_l^T + b_l) + x_l        l < n_cross
    logit   = top(x_L)

``bottom`` is ReLU after every layer; ``top`` is ReLU on every layer but the
last, whose one output is the logit. Loss: BCE with logits, the batch mean.
Optimizers: Adagrad on the dense parameters (optax's form: ``s += g^2``,
``p -= lr g / sqrt(s + eps)``, eps 1e-7) and per-element Adagrad on the
table rows (``optim.RowAdagrad``: ``acc += g^2``, ``w -= lr g / (sqrt(acc) +
eps)``, eps 1e-8), both from an accumulator of ``initial_accumulator``.

Weights are ``[in, out]`` (``x @ w``): ``cross.l.v`` is ``V_l^T`` [27 D, r],
``cross.l.w`` is ``W_l^T`` [r, 27 D]; names as the program flattens them.

``q`` is a rounding applied where a lower-precision program would round
(``precision.py``): the identity for the reference, fp8 for the control.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference.optim import RowAdagrad
from benchmark.reference.precision import rounding


def f32_products() -> None:
    """Full f32 products on the card: no TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def x0_dim(cfg: dict) -> int:
    return (cfg["n_slots"] + 1) * cfg["embed_dim"]


def init(cfg: dict, randn) -> dict:
    """Every parameter but the table, by name, all live: the MLPs He (the
    logit's layer 1/in), the cross layers Xavier normal (TorchRec's), every
    bias N(0, 0.01). ``randn(*shape, std=)`` draws them."""
    out = {}
    bottom = [cfg["n_dense"], *cfg["bottom"]]
    for k, (a, b) in enumerate(zip(bottom[:-1], bottom[1:])):
        out[f"bottom.{k}.b"] = randn(b, std=0.01)
        out[f"bottom.{k}.w"] = randn(a, b, std=(2.0 / a) ** 0.5)
    d, r = x0_dim(cfg), cfg["low_rank"]
    for k in range(cfg["n_cross"]):
        out[f"cross.{k}.b"] = randn(d, std=0.01)
        out[f"cross.{k}.v"] = randn(d, r, std=(2.0 / (d + r)) ** 0.5)
        out[f"cross.{k}.w"] = randn(r, d, std=(2.0 / (d + r)) ** 0.5)
    top = [d, *cfg["top"], 1]
    for k, (a, b) in enumerate(zip(top[:-1], top[1:])):
        last = k == len(top) - 2
        out[f"top.{k}.b"] = randn(b, std=0.01)
        out[f"top.{k}.w"] = randn(a, b, std=((1.0 if last else 2.0) / a) ** 0.5)
    return out


def mlp(h: torch.Tensor, params: dict, name: str, n_layers: int, final_linear: bool, q) -> torch.Tensor:
    for k in range(n_layers):
        h = q(h) @ q(params[f"{name}.{k}.w"]) + params[f"{name}.{k}.b"]
        if not (final_linear and k == n_layers - 1):
            h = torch.relu(h)
        h = q(h)
    return h


def pooled(rows: torch.Tensor, idx: torch.Tensor, hotness) -> torch.Tensor:
    """[B, n_slots, D]: each bag's rows (positions ``idx`` [B, n_ids] in
    ``rows``) summed."""
    r = rows[idx.long()]
    return torch.stack([part.sum(dim=1) for part in torch.split(r, list(hotness), dim=1)], dim=1)


def logits(cfg: dict, params: dict, rows: torch.Tensor, idx: torch.Tensor, dense: torch.Tensor, q) -> torch.Tensor:
    """The logits [B] of examples whose ids are positions ``idx`` in the
    table rows ``rows``."""
    e = q(pooled(rows, idx, cfg["hotness"]))
    x0 = torch.cat([mlp(dense, params, "bottom", len(cfg["bottom"]), False, q), e.reshape(e.shape[0], -1)], dim=1)
    xl = x0
    for k in range(cfg["n_cross"]):
        u = q(q(xl) @ q(params[f"cross.{k}.v"]))
        t = q(u @ q(params[f"cross.{k}.w"]) + q(params[f"cross.{k}.b"]))
        xl = q(x0 * t + xl)
    return mlp(xl, params, "top", len(cfg["top"]) + 1, True, q)[:, 0]


def norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tensors.items()}


def table_leaves(t: torch.Tensor) -> dict:
    """The table as the check's two table leaves: its rows, and the
    first-order column a fused table would have (none here: 0)."""
    return {"table.emb": t, "table.wide": t.new_zeros(t.shape[0])}


class DenseAdagrad:
    def __init__(self, params: dict, lr: float, initial_acc: float, eps: float = 1e-7):
        self.lr, self.eps = lr, eps
        self.s = {k: torch.full_like(p, initial_acc) for k, p in params.items()}

    @torch.no_grad()
    def step(self, params: dict, grads: dict) -> None:
        for k, p in params.items():
            self.s[k].add_(grads[k] * grads[k])
            p.sub_(self.lr * grads[k] / torch.sqrt(self.s[k] + self.eps))


def readings(cfg: dict, dense_params: dict, rows0: torch.Tensor, idx: torch.Tensor, dense: torch.Tensor,
             labels: torch.Tensor, precision: str = "f32", block: int = 2048) -> dict:
    """Steps on K batches: ``dense_params`` by name; ``rows0`` [U, D] the
    initial rows the batches touch; ``idx`` [K, B, n_ids] each id's position
    in ``rows0``; ``dense`` [K, B, n_dense]; ``labels`` [K, B]. Returns the
    losses, the first gradient's norms (``grad``), the dense leaves' first
    gradient (``grad_vec``), the rows' (``grad_table`` [U, D], ``rows0``'s
    order) and each leaf's change over the K steps (``change``). Batches run
    in blocks of ``block`` examples, their grads summed."""
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
