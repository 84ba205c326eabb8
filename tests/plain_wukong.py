"""A plain Wukong in f32, the reference the port's ``wukong`` is held to on
the CPU (``tests/test_torch_wukong.py``). Plain ``torch`` operations, TF32
off, autograd for every gradient; it imports neither the port nor JAX.

Wukong (arXiv:2403.02545 §3) over DLRM's pooled bags and bottom MLP:

* each slot's bag of ids summed into one row (``pooled``);
* ``X_0 = [bottom(dense); e_1; ...; e_F]`` [B, F + 1, d], bottom ReLU after
  every layer;
* each layer: ``FM = X (X^T Y)``; ``A = LN_F(flatten(FM))`` over the n k
  values; ``H = MLP_F(A)`` (ReLU between layers, the last linear) as [n_F,
  d]; ``L = W_L X``; ``X' = LN_d(concat(H, L) + P X)`` over each row's d
  values, ``P`` the identity where the widths agree, else learned; both LNs
  with scale and shift, eps 1e-5;
* top MLP on ``flatten(X_l)``, ReLU on every layer but the last, the logit;
* BCE with logits, its batch mean;
* dense Adagrad as optax (``s += g^2``; ``p -= lr g / sqrt(s + eps)``) and
  per-element Adagrad on the table (``acc += g^2``; ``w -= lr g /
  (sqrt(acc) + eps)``), both from an accumulator of 0.1.

Departures from the paper, which leaves these open: ``Y`` is a free
parameter (the paper's optimised FM may derive it from the input), LN_F
normalises the n k values of an example, MLP_F's last layer is linear, and
``P`` exists only where the widths differ (layer 1).

Parameters: ``{"bottom": [{"w", "b"}], "layers": [{"fm_y" [n, k], "lcb"
[n, n_L] (W_L^T), "ln_f_scale", "ln_f_shift" [n k], "mlp": [{"w", "b"}],
"ln_scale", "ln_shift" [d], "proj" [n, n_F + n_L] (P^T, layer 1 only)}],
"top": [{"w", "b"}]}`` with ``[in, out]`` weights, and the table ``[R,
d]``; ids ``[B, n_ids]`` global rows, slot-major bags of ``hotness``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

EPS = 1e-5


def f32_products() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def pooled(table: torch.Tensor, ids: torch.Tensor, hotness) -> torch.Tensor:
    """[B, n_bags, d]: each bag's rows summed."""
    rows = table[ids.long()]
    return torch.stack([part.sum(dim=1) for part in torch.split(rows, list(hotness), dim=1)], dim=1)


def mlp(layers: list, h: torch.Tensor, final_linear: bool) -> torch.Tensor:
    for i, layer in enumerate(layers):
        h = h @ layer["w"] + layer["b"]
        if not (final_linear and i == len(layers) - 1):
            h = torch.relu(h)
    return h


def fm(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The optimised FM, ``X (X^T Y)`` [B, n, k]."""
    return x @ (x.transpose(1, 2) @ y)


def layer(p: dict, x: torch.Tensor, n_fmb: int) -> torch.Tensor:
    b, _, d = x.shape
    f = fm(x, p["fm_y"]).reshape(b, -1)
    a = F.layer_norm(f, (f.shape[1],), p["ln_f_scale"], p["ln_f_shift"], EPS)
    h = mlp(p["mlp"], a, final_linear=True).reshape(b, n_fmb, d)
    lcb = p["lcb"].t() @ x
    r = x if "proj" not in p else p["proj"].t() @ x
    return F.layer_norm(torch.cat([h, lcb], dim=1) + r, (d,), p["ln_scale"], p["ln_shift"], EPS)


def logits_from_pooled(params: dict, dense: torch.Tensor, e: torch.Tensor, n_fmb: int) -> torch.Tensor:
    x = torch.cat([mlp(params["bottom"], dense, final_linear=False)[:, None, :], e], dim=1)
    for p in params["layers"]:
        x = layer(p, x, n_fmb)
    return mlp(params["top"], x.reshape(x.shape[0], -1), final_linear=True)[:, 0]


def logits(params: dict, table, dense, ids, hotness, n_fmb: int) -> torch.Tensor:
    return logits_from_pooled(params, dense, pooled(table, ids, hotness), n_fmb)


def loss(params: dict, table, dense, ids, labels, hotness, n_fmb: int) -> torch.Tensor:
    return F.binary_cross_entropy_with_logits(logits(params, table, dense, ids, hotness, n_fmb), labels)


def leaves(tree) -> list:
    """The parameters in the port's flatten order (dict keys sorted, lists
    in order)."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in leaves(tree[k])]
    if isinstance(tree, list):
        return [t for v in tree for t in leaves(v)]
    return [tree]


def clone(tree, grad: bool = False):
    if isinstance(tree, dict):
        return {k: clone(v, grad) for k, v in tree.items()}
    if isinstance(tree, list):
        return [clone(v, grad) for v in tree]
    return tree.detach().clone().float().requires_grad_(grad)


def train(params: dict, table: torch.Tensor, batches, hotness, n_fmb: int, dense_lr: float, emb_lr: float,
          initial_accumulator: float = 0.1, dense_eps: float = 1e-7, emb_eps: float = 1e-8):
    """Steps on ``batches`` [(dense, ids, labels)]; returns (losses, params,
    dense accumulators in flatten order, table, table accumulator), new
    tensors."""
    f32_products()
    params = clone(params, grad=True)
    table = table.detach().clone().float().requires_grad_(True)
    flat = leaves(params)
    sos = [torch.full_like(p, initial_accumulator) for p in flat]
    acc = torch.full_like(table, initial_accumulator)
    losses = []
    for dense, ids, labels in batches:
        out = loss(params, table, dense.float(), ids, labels.float(), hotness, n_fmb)
        grads = torch.autograd.grad(out, flat + [table])
        losses.append(float(out.detach()))
        with torch.no_grad():
            for p, g, s in zip(flat, grads[:-1], sos):
                s.add_(g * g)
                p.sub_(dense_lr * g / torch.sqrt(s + dense_eps))
            g = grads[-1]
            acc.add_(g * g)
            table.sub_(emb_lr * g / (torch.sqrt(acc) + emb_eps))
    return losses, clone(params), [s.clone() for s in sos], table.detach().clone(), acc.clone()
