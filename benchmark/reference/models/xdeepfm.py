"""xDeepFM's interaction (arXiv:1803.05170, eq. 6-8): the CIN with direct
connections. Field matrix ``X0 = e [B, m, D]``; layer k ``X^k[b, n, d] =
sum_{h, i} W^k[n, h, i] X^{k-1}[b, h, d] X0[b, i, d]``; every layer
sum-pooled over d; the pools times ``w_cin``."""

import torch


def init(cfg: dict, randn) -> dict:
    m, out, h_prev = cfg["n_slots"], {}, cfg["n_slots"]
    for k, h in enumerate(cfg["cin_sizes"]):
        out[f"cin.{k}"] = randn(h, h_prev, m, std=(2.0 / (h_prev * m)) ** 0.5)
        h_prev = h
    p = sum(cfg["cin_sizes"])
    out["w_cin"] = randn(p, std=p ** -0.5)
    return out


def interaction(cfg: dict, params: dict, e: torch.Tensor, q) -> torch.Tensor:
    xk, pools = e, []
    for k in range(len(cfg["cin_sizes"])):
        z = torch.einsum("bhd,bid->bhid", xk, e)
        xk = q(torch.einsum("nhi,bhid->bnd", q(params[f"cin.{k}"]), z))
        pools.append(xk.sum(dim=2))
    return torch.cat(pools, dim=1) @ params["w_cin"]
