"""Feature-interaction ops: plain PyTorch versions of
``recmodels_tpu/ops/interactions.py`` (the CIN ops, the fused-row fanout,
the FM second-order term, the DCN cross layers, PNN's inner and outer
products, NFM's bi-interaction and AFM's pair products).

Same layouts as the JAX package: fields ``[B, m, D]`` (or D-major
``[B, D, m]``), CIN weights either 3-D ``[H_next, H_k, m]`` or flat
``[H_k, m*H_next]`` with column ``i*H_next + n`` = ``w[n, h, i]``. Products
of bf16 values are formed in f32 (exactly) and summed in f32, then the
result is cast back to the input dtype, which is what JAX's
``preferred_element_type=float32`` does.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def cin_layer(xk: torch.Tensor, x0: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """One CIN layer (arXiv:1803.05170 eq. 6): xk [B, H_k, D], x0 [B, m, D],
    w [H_next, H_k, m] -> [B, H_next, D],
    ``X^{k+1}_{n,d} = sum_{h,i} w_{n,h,i} * xk_{h,d} * x0_{i,d}``."""
    out = torch.einsum("bhd,bid,nhi->bnd", xk.float(), x0.float(), w.float())
    return out.to(xk.dtype)


def cin_sum_pool(xk: torch.Tensor) -> torch.Tensor:
    """Per-feature-map sum pooling over D: [B, H, D] -> [B, H]."""
    return torch.sum(xk, dim=2)


def cin_stack(x0: torch.Tensor, ws) -> torch.Tensor:
    """Full CIN: x0 [B, m, D], ws = [w_k: [H_k, H_{k-1}, m]] -> the
    per-layer sum pools over D, concatenated: [B, sum_k H_k]."""
    xk = x0
    pools = []
    for w in ws:
        xk = cin_layer(xk, x0, w)
        pools.append(cin_sum_pool(xk))
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


def triu_pair_indices(n: int) -> tuple[np.ndarray, np.ndarray]:
    """The upper-triangle (i < j) field pairs of n fields, int32, in
    ``np.triu_indices`` row-major order: (0, 1), (0, 2), ..., (n-2, n-1)."""
    iu = np.triu_indices(n, k=1)
    return iu[0].astype(np.int32), iu[1].astype(np.int32)


@functools.lru_cache(maxsize=None)
def _pair_tensors(n: int, device: torch.device) -> tuple[torch.Tensor, ...]:
    """(fi [P], fj [P], flat [P], sym [n*n]) int64 on ``device``: the pairs
    of ``triu_pair_indices``, their positions i*n + j in a flattened n x n
    grid, and for each (i, j) of the grid the pair index of (min, max), P on
    the diagonal. Made once a device by the
    first (eager) call, so a captured step reads them and copies nothing in, and
    made as normal tensors even under ``torch.inference_mode`` (a scorer's
    first call), so that a training step may read them later."""
    fi, fj = triu_pair_indices(n)
    sym = np.full((n, n), fi.size, np.int64)
    sym[fi, fj] = sym[fj, fi] = np.arange(fi.size)
    with torch.inference_mode(False):
        return tuple(torch.as_tensor(a.astype(np.int64).reshape(-1), device=device)
                     for a in (fi, fj, fi * n + fj, sym))


def pnn_inner_products(emb: torch.Tensor) -> torch.Tensor:
    """IPNN product signal (arXiv:1611.00144): emb [B, F, D] -> the inner
    products <e_i, e_j> of the pairs i < j, [B, F(F-1)/2] in emb's dtype, in
    ``triu_pair_indices`` order.

    The JAX reference's rounding points, for bf16 input: the Gram matrix is
    one bf16 ``einsum`` whose products are exact in f32 and summed in f32,
    rounded once to bf16; the triangle is gathered from it. Here the Gram
    matrix is an f32 batched product of the widened rows (TF32 off), then
    the triangle, rounded once."""
    b, f, _ = emb.shape
    e = emb.float()
    gram = torch.bmm(e, e.transpose(1, 2)).reshape(b, f * f)
    flat = _pair_tensors(f, emb.device)[2]
    return gram.index_select(1, flat).to(emb.dtype)


def pnn_outer_product(emb: torch.Tensor) -> torch.Tensor:
    """OPNN superposition (arXiv:1611.00144 §3.2): emb [B, F, D] ->
    ``s s^T`` [B, D, D] in emb's dtype, s = sum_f e_f.

    The JAX reference's rounding points, for bf16 input: ``jnp.sum`` adds in
    f32 and rounds s to bf16; each product s_i * s_j rounds."""
    s = emb.float().sum(dim=1).to(emb.dtype)
    return s[:, :, None] * s[:, None, :]


def fm_bi_interaction(emb: torch.Tensor) -> torch.Tensor:
    """NFM bi-interaction pooling (arXiv:1708.05027 eq. 4): emb [B, F, D] ->
    ``0.5 * (s * s - sum_f e_f * e_f)`` [B, D] in emb's dtype, s = sum_f e_f
    (``fm_pairwise`` is its sum over D).

    The JAX reference's rounding points, for bf16 input (as XLA compiles it,
    the squares e*e widened to f32 and so exact): s and sum_f e*e add in f32
    and round once; s*s rounds; the difference rounds, and the halving is
    exact."""
    dt = emb.dtype
    e = emb.float()
    s = e.sum(dim=1).to(dt)
    sq = (e * e).sum(dim=1).to(dt)
    return 0.5 * (s * s - sq)


class AfmPairProducts(torch.autograd.Function):
    """e [B, F, D] -> e_i * e_j [B, P, D] for the pairs of
    ``triu_pair_indices``. Each field takes part in F - 1 pairs, so autograd's
    backward of two ``index_select``s would sum duplicate indices by
    ``index_add_``, whose atomics on the card add in no fixed order. This
    backward gathers the pair grads into a symmetric [B, F, F, D] grid
    (zeros on its diagonal) and sums each field's row of grad * e_j in f32,
    in order, rounded once: the same bits on every run, as a replayed step
    must give the eager step's."""

    @staticmethod
    def forward(ctx, emb: torch.Tensor) -> torch.Tensor:
        fi, fj, _, _ = _pair_tensors(emb.shape[1], emb.device)
        ctx.save_for_backward(emb)
        return emb.index_select(1, fi) * emb.index_select(1, fj)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        (emb,) = ctx.saved_tensors
        b, f, d = emb.shape
        sym = _pair_tensors(f, emb.device)[3]
        g_pad = torch.cat((g, g.new_zeros((b, 1, d))), dim=1)
        grid = g_pad.index_select(1, sym).reshape(b, f, f, d)
        return (grid.float() * emb.float()[:, None]).sum(dim=2).to(emb.dtype)


def afm_pair_products(emb: torch.Tensor) -> torch.Tensor:
    """AFM pairwise element-wise products (arXiv:1708.04617 §3): emb [B, F,
    D] -> e_i * e_j for i < j, [B, F(F-1)/2, D] in emb's dtype, in
    ``triu_pair_indices`` order (the JAX reference's row-major slices).

    Rounding: each product rounds once to emb's dtype, as in the JAX
    reference."""
    return AfmPairProducts.apply(emb)
