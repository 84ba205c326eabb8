"""The front end of a Wukong layer's Factorization Machine Block and its
Linear Compress Block (``models/wukong.py``): the CUDA kernels of
``csrc/wukong_fm.cu`` and their plain PyTorch versions.

For each example's ``X`` [n, d] (the layer's input, n embeddings of width d):

* ``fm_forward(x, y, w, scale, shift, eps)`` -> ``(a, l, mean, rstd)``:
  ``Z = c(X^T Y)`` [d, k], ``F = X Z`` [n, k] summed in f32,
  ``a = c(LN_F(flatten(F)))`` [n k] (the mean and variance of the example's
  n k values in f32, then ``scale`` and ``shift``), ``l = c(w^T X)`` [n_L,
  d], and the LN's per-example ``mean`` and ``rstd`` (f32), which the
  backward reads; c is x's dtype. One kernel (``wukong_fm_fwd_kernel``).
* ``fm_backward(x, y, w, scale, mean, rstd, g_a, g_s, n_f, g_res)`` ->
  ``(g_x, g_y, g_w, g_scale, g_shift)``: ``g_a`` the cotangent of ``a``;
  ``g_s`` [B, m, d] the cotangent of the layer's residual sum, whose rows
  ``n_f .. n_f + n_L`` are ``l``'s; ``g_res`` [B, n, d] the cotangent that
  reaches ``X`` by the residual path, added before the one rounding. ``g_x``
  in c; the weights' grads f32 batch sums in a fixed order (two calls give
  the same bits). Two kernels (``wukong_fm_bwd_kernel``, then
  ``wukong_fm_grad_sum_kernel`` over its per-block partial sums).

The backward, for an example (g_F's and g_Z's roundings are the kernel's
operand roundings): ``x̂ = (F - mean) rstd``; ``g_x̂ = g_a scale``; ``g_F =
c(rstd (g_x̂ - mean(g_x̂) - x̂ mean(g_x̂ x̂)))``; ``g_Z^T = c(g_F^T X)``;
``g_x = c(g_F Z^T + Y g_Z^T + w g_L + g_res)``; ``g_y = sum_b X g_Z``,
``g_w = sum_b X g_L^T``, ``g_scale = sum_b g_a x̂``, ``g_shift = sum_b
g_a``. Z and F are computed again from X rather than saved.

Layouts: ``x`` [B, n, d], ``y`` [n, k], ``w`` [n, n_L] (``W_L^T``, the
repo's ``[in, out]``), ``scale`` and ``shift`` [n k] f32 in ``F``'s
row-major flatten order.

Each entry chooses by its tensors: a bf16 tensor on the card launches the
kernels (or raises for a shape they do not take: n <= 32, k 16 or 32, n_L
<= 32, d a multiple of 16 up to 256); f32, and any tensor on the CPU, takes
the plain version: two ``bmm``s, ``layer_norm`` and a ``matmul``.
"""

from __future__ import annotations

import torch

from recmodels_tpu_torch.ops.cuda import build
from recmodels_tpu_torch.ops.cuda.launch import cuda_device, device_and_stream, require


def kernel_route(x: torch.Tensor) -> bool:
    """Whether ``x`` takes the kernels: bf16 on the card."""
    return x.device.type == "cuda" and x.dtype == torch.bfloat16


def fm_forward_reference(x, y, w, scale, shift, eps: float):
    """Plain version of ``fm_forward``: the products of c operands summed in
    f32 (on the CPU the operands widened to f32, exactly), rounded at the
    kernel's points."""
    c = x.dtype
    b = x.shape[0]
    xf = x.float()
    z = torch.matmul(xf.transpose(1, 2), y.float()).to(c)  # [B, d, k]
    f = torch.bmm(xf, z.float()).reshape(b, -1)  # [B, n k]
    a, mean, rstd = torch.native_layer_norm(f, (f.shape[1],), scale, shift, eps)
    l = torch.matmul(w.float().t(), xf).to(c)  # [B, n_L, d]
    return a.to(c), l, mean.reshape(b), rstd.reshape(b)


def fm_backward_reference(x, y, w, scale, mean, rstd, g_a, g_s, n_f: int, g_res):
    """Plain version of ``fm_backward`` (the module docstring's formulas)."""
    c = x.dtype
    b, n, _ = x.shape
    k, n_l = y.shape[1], w.shape[1]
    xf, yf, wf = x.float(), y.float(), w.float()
    z = torch.matmul(xf.transpose(1, 2), yf).to(c).float()  # [B, d, k]
    f = torch.bmm(xf, z).reshape(b, -1)
    xhat = (f - mean[:, None]) * rstd[:, None]
    ga = g_a.float()
    g_scale, g_shift = (ga * xhat).sum(dim=0), ga.sum(dim=0)
    gxh = ga * scale
    gf = rstd[:, None] * (gxh - gxh.mean(dim=1, keepdim=True) - xhat * (gxh * xhat).mean(dim=1, keepdim=True))
    gf = gf.to(c).float().reshape(b, n, k)
    gzt = torch.bmm(gf.transpose(1, 2), xf).to(c).float()  # g_Z^T [B, k, d]
    g_l = g_s[:, n_f:n_f + n_l].float()
    g_x = torch.bmm(gf, z.transpose(1, 2)) + torch.matmul(yf, gzt) + torch.matmul(wf, g_l) + g_res.float()
    g_y = torch.bmm(xf, gzt.transpose(1, 2)).sum(dim=0)
    g_w = torch.bmm(xf, g_l.transpose(1, 2)).sum(dim=0)
    return g_x.to(c), g_y, g_w, g_scale, g_shift


def _check_shapes(what: str, x, y, w, scale) -> tuple[int, int, int, int, int]:
    b, n, d = x.shape
    k, n_l = y.shape[1], w.shape[1]
    if y.shape[0] != n or w.shape[0] != n or scale.shape != (n * k,):
        raise ValueError(f"{what}: x {tuple(x.shape)}, y {tuple(y.shape)}, w {tuple(w.shape)}, "
                         f"scale {tuple(scale.shape)} do not fit")
    if not (1 <= n <= 32 and k in (16, 32) and 1 <= n_l <= 32 and d % 16 == 0 and 16 <= d <= 256):
        raise ValueError(f"{what}: no kernel for n {n}, k {k}, n_L {n_l}, d {d} (n <= 32, k 16 or 32, "
                         f"n_L <= 32, d a multiple of 16 up to 256)")
    return b, n, d, k, n_l


def fm_forward(x, y, w, scale, shift, eps: float = 1e-5):
    """``(a [B, n k], l [B, n_L, d], mean [B], rstd [B])`` of ``x`` [B, n, d],
    ``y`` [n, k], ``w`` [n, n_L] (bf16 on the card, or any on the CPU) and
    ``scale``, ``shift`` [n k] f32."""
    if not kernel_route(x):
        return fm_forward_reference(x, y, w, scale, shift, eps)
    dev_t = cuda_device(x, "fm_forward")
    for name, t, dtypes, nd in (("x", x, (torch.bfloat16,), 3), ("y", y, (torch.bfloat16,), 2),
                                ("w", w, (torch.bfloat16,), 2), ("scale", scale, (torch.float32,), 1),
                                ("shift", shift, (torch.float32,), 1)):
        require(f"fm_forward {name}", t, dtypes, nd, dev_t, align=16 if name == "x" else 4)
    b, n, d, k, n_l = _check_shapes("fm_forward", x, y, w, scale)
    if shift.shape != scale.shape:
        raise ValueError(f"fm_forward: shift {tuple(shift.shape)}, expected {tuple(scale.shape)}")
    a = torch.empty((b, n * k), dtype=torch.bfloat16, device=dev_t)
    l = torch.empty((b, n_l, d), dtype=torch.bfloat16, device=dev_t)
    mean = torch.empty((b,), dtype=torch.float32, device=dev_t)
    rstd = torch.empty((b,), dtype=torch.float32, device=dev_t)
    dev, stream = device_and_stream(dev_t)
    err = build.library().rm_wukong_fm_forward(dev, x.data_ptr(), y.data_ptr(), w.data_ptr(), scale.data_ptr(),
                                               shift.data_ptr(), a.data_ptr(), l.data_ptr(), mean.data_ptr(),
                                               rstd.data_ptr(), b, n, d, k, n_l, eps, stream)
    build.check(err, "fm_forward")
    fm_forward.launches += 1
    return a, l, mean, rstd


fm_forward.launches = 0  # kernel launches since the count was last set to 0


def fm_backward(x, y, w, scale, mean, rstd, g_a, g_s, n_f: int, g_res):
    """``(g_x [B, n, d], g_y [n, k], g_w [n, n_L], g_scale, g_shift [n k])``
    for ``fm_forward``'s inputs, its saved ``mean`` and ``rstd``, ``g_a`` [B,
    n k], ``g_s`` [B, m, d] (``l``'s cotangent its rows ``n_f .. n_f +
    n_L``) and ``g_res`` [B, n, d]."""
    if not kernel_route(x):
        return fm_backward_reference(x, y, w, scale, mean, rstd, g_a, g_s, n_f, g_res)
    dev_t = cuda_device(x, "fm_backward")
    for name, t, dtypes, nd in (("x", x, (torch.bfloat16,), 3), ("y", y, (torch.bfloat16,), 2),
                                ("w", w, (torch.bfloat16,), 2), ("scale", scale, (torch.float32,), 1),
                                ("mean", mean, (torch.float32,), 1), ("rstd", rstd, (torch.float32,), 1),
                                ("g_a", g_a, (torch.bfloat16,), 2), ("g_s", g_s, (torch.bfloat16,), 3),
                                ("g_res", g_res, (torch.bfloat16,), 3)):
        require(f"fm_backward {name}", t, dtypes, nd, dev_t, align=16 if name in ("x", "g_s", "g_res") else 4)
    b, n, d, k, n_l = _check_shapes("fm_backward", x, y, w, scale)
    m = g_s.shape[1]
    if (mean.shape != (b,) or rstd.shape != (b,) or g_a.shape != (b, n * k) or g_s.shape[::2] != (b, d)
            or not 0 <= n_f <= m - n_l or g_res.shape != x.shape):
        raise ValueError(f"fm_backward: mean {tuple(mean.shape)}, g_a {tuple(g_a.shape)}, g_s {tuple(g_s.shape)} "
                         f"at row {n_f}, g_res {tuple(g_res.shape)} do not fit x {tuple(x.shape)}")
    lib = build.library()
    g_x = torch.empty_like(x)
    g_y = torch.empty((n, k), dtype=torch.float32, device=dev_t)
    g_w = torch.empty((n, n_l), dtype=torch.float32, device=dev_t)
    g_scale = torch.empty((n * k,), dtype=torch.float32, device=dev_t)
    g_shift = torch.empty((n * k,), dtype=torch.float32, device=dev_t)
    partials = torch.empty((lib.rm_wukong_fm_partial_floats(b, k, n_l),), dtype=torch.float32, device=dev_t)
    dev, stream = device_and_stream(dev_t)
    err = lib.rm_wukong_fm_backward(dev, x.data_ptr(), y.data_ptr(), w.data_ptr(), scale.data_ptr(),
                                    mean.data_ptr(), rstd.data_ptr(), g_a.data_ptr(), g_s.data_ptr(),
                                    g_res.data_ptr(), g_x.data_ptr(), partials.data_ptr(), g_y.data_ptr(),
                                    g_w.data_ptr(), g_scale.data_ptr(), g_shift.data_ptr(), b, n, d, k, n_l, m,
                                    n_f, stream)
    build.check(err, "fm_backward")
    fm_backward.launches += 1
    return g_x, g_y, g_w, g_scale, g_shift


fm_backward.launches = 0  # calls (two kernels each) since the count was last set to 0
