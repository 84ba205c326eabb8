"""Feature-interaction ops: plain PyTorch versions of
``recmodels_tpu/ops/interactions.py`` (the CIN ops, the fused-row fanout,
the FM second-order term and the DCN cross layers).

Same layouts as the JAX package: fields ``[B, m, D]`` (or D-major
``[B, D, m]``), CIN weights either 3-D ``[H_next, H_k, m]`` or flat
``[H_k, m*H_next]`` with column ``i*H_next + n`` = ``w[n, h, i]``. Products
of bf16 values are formed in f32 (exactly) and summed in f32, then the
result is cast back to the input dtype, which is what JAX's
``preferred_element_type=float32`` does.
"""

from __future__ import annotations

import torch


def cin_layer(xk: torch.Tensor, x0: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """One CIN layer (arXiv:1803.05170 eq. 6): xk [B, H_k, D], x0 [B, m, D],
    w [H_next, H_k, m] -> [B, H_next, D],
    ``X^{k+1}_{n,d} = sum_{h,i} w_{n,h,i} * xk_{h,d} * x0_{i,d}``."""
    out = torch.einsum("bhd,bid,nhi->bnd", xk.float(), x0.float(), w.float())
    return out.to(xk.dtype)


def cin_stack(x0: torch.Tensor, ws) -> torch.Tensor:
    """Full CIN: x0 [B, m, D], ws = [w_k: [H_k, H_{k-1}, m]] -> the
    per-layer sum pools over D, concatenated: [B, sum_k H_k]."""
    xk = x0
    pools = []
    for w in ws:
        xk = cin_layer(xk, x0, w)
        pools.append(torch.sum(xk, dim=2))
    return torch.cat(pools, dim=1)


def cin_stack_dm(x0_dm: torch.Tensor, ws) -> torch.Tensor:
    """``cin_stack`` from a D-major field matrix x0_dm [B, D, m]."""
    return cin_stack(x0_dm.transpose(1, 2), ws)


def flatten_cin_w(w: torch.Tensor) -> torch.Tensor:
    """[H_next, H_k, m] -> flat [H_k, m*H_next]."""
    hn, hk, m = w.shape
    return w.permute(1, 2, 0).reshape(hk, m * hn)


def unflatten_cin_w(w2: torch.Tensor, m: int) -> torch.Tensor:
    """Inverse of ``flatten_cin_w``: [H_k, m*H_next] -> [H_next, H_k, m]."""
    hk = w2.shape[0]
    hn = w2.shape[1] // m
    return w2.reshape(hk, m, hn).permute(2, 0, 1)


def cin_stack_flat(x0: torch.Tensor, w2s) -> torch.Tensor:
    """``cin_stack`` with flat weights [H_k, m*H_next]."""
    m = x0.shape[1]
    return cin_stack(x0, [unflatten_cin_w(w2, m) for w2 in w2s])


def cin_stack_dm_flat(x0_dm: torch.Tensor, w2s) -> torch.Tensor:
    """``cin_stack_dm`` with flat weights."""
    return cin_stack_flat(x0_dm.transpose(1, 2), w2s)


def split_fused_rows(full: torch.Tensor, emb_dim: int):
    """Fanout for wide-fused rows [B, m, D+1] -> (x_dm [B, D, m] in the rows'
    dtype, wide_sum [B] f32, the sum over m of the last column)."""
    x_dm = full[..., :emb_dim].transpose(1, 2).contiguous()
    wide_sum = full[..., emb_dim].float().sum(dim=1)
    return x_dm, wide_sum


def fm_pairwise(emb: torch.Tensor) -> torch.Tensor:
    """FM second-order term by the sum-square identity (Rendle 2010): emb
    [B, F, D] -> ``0.5 * (sum_d s_d^2 - sum_{f,d} e_fd^2)`` [B] in emb's
    dtype, s_d = sum_f e_fd.

    The JAX reference's rounding points, for bf16 input: each of the three
    sums (s, sum e^2, sum s^2) adds in f32 and rounds once to bf16
    (``jnp.sum`` upcasts); the squares ``e*e`` and ``s*s`` round
    elementwise; the difference rounds, and the halving is exact. In f32
    nothing rounds between the steps."""
    dt = emb.dtype
    s = emb.float().sum(dim=1).to(dt)
    sq = (emb * emb).float().sum(dim=(1, 2)).to(dt)
    ss = (s * s).float().sum(dim=1).to(dt)
    return 0.5 * (ss - sq)


def dcn_cross_layer(x0: torch.Tensor, xl: torch.Tensor, w: torch.Tensor,
                    b: torch.Tensor) -> torch.Tensor:
    """One DCN cross layer (arXiv:1708.05123): x0, xl [B, d], w, b [d] ->
    ``x0 * (xl . w) + b + xl`` [B, d].

    The JAX reference's rounding points, for bf16 input: t = xl . w is the
    f32 sum of exact products, rounded once (``einsum("bd,d->b")``); then
    ``x0 * t``, ``+ b`` and ``+ xl`` each round."""
    t = (xl.float() @ w.float()).to(xl.dtype)
    return x0 * t[:, None] + b[None, :] + xl


def dcn_cross_stack(x0: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """All L cross layers: x0 [B, d], w [L, d], b [L, d] -> x_L [B, d]."""
    xl = x0
    for layer in range(w.shape[0]):
        xl = dcn_cross_layer(x0, xl, w[layer], b[layer])
    return xl
