"""A plain DLRM-DCNv2 in f32, the reference the port's ``dlrm_dcnv2`` is held
to on the CPU (``tests/test_torch_dlrm_dcnv2.py``). Plain ``torch``
operations, TF32 off; it imports neither the port nor JAX.

DLRM (arXiv:1906.00091) with DCN-V2's low-rank cross layers
(arXiv:2008.13535 eq. 1-2), as TorchRec's ``DLRM_DCN``:

* each slot's bag of ids summed into one row (``pooled``);
* bottom MLP on the dense features, ReLU after every layer;
* ``x0 = concat(bottom, e_1, ..., e_F)``;
* ``x_{l+1} = x0 * ((x_l V_l^T) W_l^T + b_l) + x_l``;
* top MLP, ReLU on every layer but the last, the logit;
* BCE with logits, its batch mean;
* dense Adagrad as optax (``s += g^2``; ``p -= lr g / sqrt(s + eps)``) and
  per-element Adagrad on the table (``acc += g^2``; ``w -= lr g / (sqrt(acc)
  + eps)``), both from an accumulator of 0.1; a table row no id names has a
  zero grad and keeps its values.

Parameters: ``{"bottom": [{"w", "b"}], "cross": [{"b", "v", "w"}], "top":
[{"w", "b"}]}`` with ``[in, out]`` weights (``v`` is ``V_l^T``, ``w`` is
``W_l^T``), and the table ``[R, d]``; ids ``[B, n_ids]`` global rows,
slot-major bags of ``hotness``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def f32_products() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def pooled(table: torch.Tensor, ids: torch.Tensor, hotness) -> torch.Tensor:
    """[B, n_bags, d]: each bag's rows summed."""
    rows = table[ids.long()]
    out, c = [], 0
    for h in hotness:
        out.append(rows[:, c:c + h].sum(dim=1))
        c += h
    return torch.stack(out, dim=1)


def mlp(layers: list, h: torch.Tensor, final_linear: bool) -> torch.Tensor:
    for i, layer in enumerate(layers):
        h = h @ layer["w"] + layer["b"]
        if not (final_linear and i == len(layers) - 1):
            h = torch.relu(h)
    return h


def logits_from_pooled(params: dict, dense: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    x0 = torch.cat([mlp(params["bottom"], dense, final_linear=False), e.reshape(e.shape[0], -1)], dim=1)
    xl = x0
    for c in params["cross"]:
        xl = x0 * ((xl @ c["v"]) @ c["w"] + c["b"]) + xl
    return mlp(params["top"], xl, final_linear=True)[:, 0]


def logits(params: dict, table: torch.Tensor, dense: torch.Tensor, ids: torch.Tensor, hotness) -> torch.Tensor:
    return logits_from_pooled(params, dense, pooled(table, ids, hotness))


def loss(params: dict, table: torch.Tensor, dense, ids, labels, hotness) -> torch.Tensor:
    return F.binary_cross_entropy_with_logits(logits(params, table, dense, ids, hotness), labels)


def leaves(params: dict) -> list:
    """The parameters in the port's flatten order."""
    out = []
    for key in sorted(params):
        for layer in params[key]:
            out.extend(layer[k] for k in sorted(layer))
    return out


def train(params: dict, table: torch.Tensor, batches, hotness, dense_lr: float, emb_lr: float,
          initial_accumulator: float = 0.1, dense_eps: float = 1e-7, emb_eps: float = 1e-8):
    """Steps on ``batches`` [(dense, ids, labels)]; returns (losses, params,
    dense accumulators in flatten order, table, table accumulator), new
    tensors."""
    f32_products()
    params = {k: [{n: t.detach().clone().float().requires_grad_(True) for n, t in layer.items()}
                  for layer in v] for k, v in params.items()}
    table = table.detach().clone().float().requires_grad_(True)
    flat = leaves(params)
    sos = [torch.full_like(p, initial_accumulator) for p in flat]
    acc = torch.full_like(table, initial_accumulator)
    losses = []
    for dense, ids, labels in batches:
        out = loss(params, table, dense.float(), ids, labels.float(), hotness)
        grads = torch.autograd.grad(out, flat + [table])
        losses.append(float(out.detach()))
        with torch.no_grad():
            for p, g, s in zip(flat, grads[:-1], sos):
                s.add_(g * g)
                p.sub_(dense_lr * g / torch.sqrt(s + dense_eps))
            g = grads[-1]
            acc.add_(g * g)
            table.sub_(emb_lr * g / (torch.sqrt(acc) + emb_eps))
    detach = lambda t: t.detach().clone()  # noqa: E731
    return (losses, {k: [{n: detach(t) for n, t in layer.items()} for layer in v] for k, v in params.items()},
            [detach(s) for s in sos], detach(table), detach(acc))
