"""Plain Adam (dense parameters) and Adagrad (table rows), f32, as their
papers and optax state them.

* Adam: ``mu = b1 mu + (1 - b1) g``; ``nu = b2 nu + (1 - b2) g^2``;
  ``p -= lr (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps)``.
* Adagrad on rows: ``acc += g^2``; ``w -= lr g / (sqrt(acc) + eps)``,
  ``acc`` starting at ``initial_acc``. On a table it equals the dense
  update: a row whose grad is 0 does not move.
"""

from __future__ import annotations

import torch


class Adam:
    def __init__(self, params: dict, lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.t = 0
        self.mu = {k: torch.zeros_like(p) for k, p in params.items()}
        self.nu = {k: torch.zeros_like(p) for k, p in params.items()}

    @torch.no_grad()
    def step(self, params: dict, grads: dict) -> None:
        self.t += 1
        bc1, bc2 = 1.0 - self.b1 ** self.t, 1.0 - self.b2 ** self.t
        for k, p in params.items():
            g = grads[k]
            self.mu[k].mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            self.nu[k].mul_(self.b2).add_(g * g, alpha=1.0 - self.b2)
            p.sub_(self.lr * (self.mu[k] / bc1) / (torch.sqrt(self.nu[k] / bc2) + self.eps))


class RowAdagrad:
    def __init__(self, rows: torch.Tensor, lr: float, initial_acc: float = 0.1, eps: float = 1e-8):
        self.lr, self.eps = lr, eps
        self.acc = torch.full_like(rows, initial_acc)

    @torch.no_grad()
    def step(self, rows: torch.Tensor, grad: torch.Tensor) -> None:
        self.acc.add_(grad * grad)
        rows.sub_(self.lr * grad / (torch.sqrt(self.acc) + self.eps))
