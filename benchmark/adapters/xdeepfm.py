"""The program's xDeepFM (``recmodels_tpu_torch/models/xdeepfm.py``): its
CIN weights are flat ``[H_{k-1}, m H_k]`` (column ``i * H_k + n`` holds
``W[n, h, i]``), and its DNN takes the rows D-major (``d * m + j``)."""

import torch


def model_kwargs(cfg: dict) -> dict:
    return {"cin_sizes": tuple(cfg["cin_sizes"])}


def to_program(cfg: dict, name: str, w: torch.Tensor) -> torch.Tensor:
    if name.startswith("cin."):
        h, h_prev, m = w.shape
        return w.permute(1, 2, 0).reshape(h_prev, m * h)
    if name == "mlp.0.w":
        m, d = cfg["n_slots"], cfg["embed_dim"]
        return torch.cat([w[: m * d].reshape(m, d, -1).transpose(0, 1).reshape(m * d, -1), w[m * d:]])
    return w
