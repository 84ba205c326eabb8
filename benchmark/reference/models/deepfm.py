"""DeepFM's interaction (arXiv:1703.04247, §2): the FM's second-order term
``1/2 sum_d ((sum_j e_jd)^2 - sum_j e_jd^2)``; the first-order term and the
DNN are the shared model's."""

import torch


def init(cfg: dict, randn) -> dict:
    return {}


def interaction(cfg: dict, params: dict, e: torch.Tensor, q) -> torch.Tensor:
    s = e.sum(dim=1)
    return q(0.5 * ((s * s).sum(dim=1) - (e * e).sum(dim=(1, 2))))
