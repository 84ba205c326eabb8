"""The reference's first training steps, and what a run compares of them.

``readings`` trains the plain model (``model.py``) from the benchmark's
weights on the first batches of a run, with plain Adam on the dense
parameters and Adagrad on the table rows (``optim.py``), and returns:

* ``loss``: each step's mean BCE;
* ``grad``: the norm of each leaf's first gradient, and the gradient
  itself: ``grad_vec`` (the dense leaves by name) and ``grad_table`` (the
  rows' [U, D + 1], in ``rows0``'s order);
* ``change``: the norm of each leaf's change over all the steps.

The table is held as the rows the batches touch (``rows0``, indexed by
``idx``): a row no batch touches has a zero gradient and does not move, so
its norms are those of the whole table. It is read as two leaves,
``table.emb`` (the embedding columns) and ``table.wide`` (the first-order
column). Batches run in blocks of rows, their grads summed, so that a
full-size batch fits beside its activations.
"""

from __future__ import annotations

import torch

from benchmark.reference import model
from benchmark.reference.optim import Adam, RowAdagrad
from benchmark.reference.precision import rounding


def f32_products() -> None:
    """Full f32 products on the card: no TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def table_leaves(cfg: dict, t: torch.Tensor) -> dict:
    d = cfg["embed_dim"]
    return {"table.emb": t[:, :d], "table.wide": t[:, d]}


def norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tensors.items()}


def readings(cfg: dict, dense_params: dict, rows0: torch.Tensor, idx: torch.Tensor, dense: torch.Tensor,
             labels: torch.Tensor, precision: str = "f32", block: int = 2048) -> dict:
    """``dense_params``: the weights but the table, by name; ``rows0``
    [U, D + 1] the initial rows the batches touch; ``idx`` [K, B, m] each
    example's rows as positions in ``rows0``; ``dense`` [K, B, n_dense],
    ``labels`` [K, B]. K steps."""
    f32_products()
    q = rounding(precision)
    params = {k: v.detach().clone().float().requires_grad_(True) for k, v in dense_params.items()}
    start = {k: v.detach().clone() for k, v in params.items()}
    rows = rows0.detach().clone().float().requires_grad_(True)
    adam = Adam(params, cfg["dense_lr"])
    adagrad = RowAdagrad(rows, cfg["emb_lr"], cfg["initial_accumulator"])
    out = {"loss": [], "grad": None, "grad_vec": None, "grad_table": None, "change": None}
    k_steps, b = idx.shape[:2]
    for k in range(k_steps):
        for p in (*params.values(), rows):
            p.grad = None
        loss = 0.0
        for s in range(0, b, block):
            sl = slice(s, min(b, s + block))
            z = model.logits(cfg, params, rows[idx[k, sl].long()], dense[k, sl], q)
            part = model.bce_sum(z, labels[k, sl]) / b
            part.backward()
            loss += float(part.detach().double())
        out["loss"].append(loss)
        grads = {n: p.grad for n, p in params.items()}
        if k == 0:
            out["grad"] = norms({**grads, **table_leaves(cfg, rows.grad)})
            out["grad_vec"] = {n: g.detach().clone() for n, g in grads.items()}
            out["grad_table"] = rows.grad.detach().clone()
        adam.step(params, grads)
        adagrad.step(rows.data, rows.grad)
    with torch.no_grad():
        out["change"] = norms({**{n: p - start[n] for n, p in params.items()},
                               **table_leaves(cfg, rows - rows0)})
    return out


@torch.no_grad()
def serve_logits(cfg: dict, dense_params: dict, rows: torch.Tensor, dense: torch.Tensor,
                 precision: str = "f32", block: int = 4096) -> torch.Tensor:
    """Logits [N] of examples whose gathered rows are ``rows`` [N, m, D + 1]."""
    f32_products()
    q = rounding(precision)
    params = {k: v.float() for k, v in dense_params.items()}
    return torch.cat([model.logits(cfg, params, rows[s:s + block].float(), dense[s:s + block], q)
                      for s in range(0, rows.shape[0], block)])
