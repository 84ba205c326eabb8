"""The residual sum and LayerNorm that close a Wukong layer (``models/wukong.py``):
the CUDA kernels of ``csrc/wukong_ln.cu`` and their plain PyTorch versions.

For a layer whose FMB wrote ``h`` [B, n_F d], whose LCB wrote ``l`` [B,
n_L, d] and whose residual is ``r`` [B, m, d] (m = n_F + n_L), c their dtype:

* ``residual_ln_forward(h, l, r, scale, shift, eps)`` -> ``(s, y, mean,
  rstd)``: ``s = c(concat(h, l) + r)`` [B, m, d] (the f32 sum rounded once),
  ``y = c((s - mean) rstd scale + shift)`` with each row's mean and rstd of
  its d values of s in f32 ([B m]) and ``scale``, ``shift`` [d] in f32. One
  kernel (``wukong_ln_fwd_kernel``).
* ``residual_ln_backward(g, s, mean, rstd, scale, n_f)`` -> ``(g_s, g_h,
  g_scale, g_shift)``: ``g_s = c(rstd (g_hat - mean(g_hat) - x_hat
  mean(g_hat x_hat)))`` [B, m, d] with ``g_hat = g scale`` and ``x_hat =
  (s - mean) rstd`` in f32; ``g_h`` [B, n_F d] its rows below n_F,
  contiguous (the FMB's MLP's cotangent); the f32 batch sums ``g_scale =
  sum g x_hat`` and ``g_shift = sum g`` in a fixed order (two calls give the
  same bits). Two kernels (``wukong_ln_bwd_kernel``, then
  ``wukong_ln_grad_sum_kernel`` over its per-block partial sums).

The scale and shift stay f32 (as autocast keeps a LayerNorm's): PyTorch's
fused ``layer_norm`` on the card takes them only in the input's dtype, and
scales near 1 rounded to bf16 put the same per-channel error on every
example's output.

Each entry chooses by its tensors: bf16 on the card launches the kernels (or
raises for a width they do not take: d 32, 64, 128 or 256); f32, and any tensor
on the CPU, takes the plain version: ``cat``, an add and ``native_layer_norm``
(and its backward) in f32.
"""

from __future__ import annotations

import torch

from recmodels_tpu_torch.nn.wukong_fm import kernel_route
from recmodels_tpu_torch.ops.cuda import build
from recmodels_tpu_torch.ops.cuda.launch import cuda_device, device_and_stream, require


def residual_ln_forward_reference(h, l, r, scale, shift, eps: float):
    """Plain version of ``residual_ln_forward``."""
    c = r.dtype
    b, _, d = r.shape
    s = (torch.cat([h.reshape(b, -1, d), l], dim=1).float() + r.float()).to(c)
    y, mean, rstd = torch.native_layer_norm(s.float(), (d,), scale, shift, eps)
    return s, y.to(c), mean.reshape(-1), rstd.reshape(-1)


def residual_ln_backward_reference(g, s, mean, rstd, scale, n_f: int):
    """Plain version of ``residual_ln_backward``."""
    b, m, d = s.shape
    # the shift's value plays no part; the op sizes its grad by it
    g_s, g_scale, g_shift = torch.ops.aten.native_layer_norm_backward(
        g.float(), s.float(), (d,), mean.reshape(b, m, 1), rstd.reshape(b, m, 1), scale, torch.zeros_like(scale),
        [True, True, True])
    g_s = g_s.to(s.dtype)
    return g_s, g_s[:, :n_f].reshape(b, n_f * d), g_scale, g_shift


def residual_ln_forward(h, l, r, scale, shift, eps: float = 1e-5):
    """``(s [B, m, d], y [B, m, d], mean [B m], rstd [B m])`` of ``h`` [B,
    n_F d], ``l`` [B, n_L, d], ``r`` [B, m, d] and ``scale``, ``shift`` [d]
    f32."""
    if not kernel_route(r):
        return residual_ln_forward_reference(h, l, r, scale, shift, eps)
    dev_t = cuda_device(r, "residual_ln_forward")
    for name, t, dtypes, nd in (("h", h, (torch.bfloat16,), 2), ("l", l, (torch.bfloat16,), 3),
                                ("r", r, (torch.bfloat16,), 3), ("scale", scale, (torch.float32,), 1),
                                ("shift", shift, (torch.float32,), 1)):
        require(f"residual_ln_forward {name}", t, dtypes, nd, dev_t, align=16 if nd > 1 else 4)
    b, m, d = r.shape
    n_f = m - l.shape[1]
    if (h.shape != (b, n_f * d) or l.shape[::2] != (b, d) or scale.shape != (d,) or shift.shape != (d,)
            or d not in (32, 64, 128, 256)):
        raise ValueError(f"residual_ln_forward: h {tuple(h.shape)}, l {tuple(l.shape)}, r {tuple(r.shape)}, "
                         f"scale {tuple(scale.shape)} do not fit (d 32, 64, 128 or 256)")
    s = torch.empty_like(r)
    y = torch.empty_like(r)
    mean = torch.empty((b * m,), dtype=torch.float32, device=dev_t)
    rstd = torch.empty((b * m,), dtype=torch.float32, device=dev_t)
    dev, stream = device_and_stream(dev_t)
    err = build.library().rm_wukong_ln_forward(dev, h.data_ptr(), l.data_ptr(), r.data_ptr(), scale.data_ptr(),
                                               shift.data_ptr(), s.data_ptr(), y.data_ptr(), mean.data_ptr(),
                                               rstd.data_ptr(), b, m, n_f, d, eps, stream)
    build.check(err, "residual_ln_forward")
    residual_ln_forward.launches += 1
    return s, y, mean, rstd


residual_ln_forward.launches = 0  # kernel launches since the count was last set to 0


def residual_ln_backward(g, s, mean, rstd, scale, n_f: int):
    """``(g_s [B, m, d], g_h [B, n_f d], g_scale [d], g_shift [d])`` for the
    cotangent ``g`` [B, m, d] of ``residual_ln_forward``'s ``y``, its ``s``,
    ``mean`` and ``rstd``, and ``scale``."""
    if not kernel_route(s):
        return residual_ln_backward_reference(g, s, mean, rstd, scale, n_f)
    dev_t = cuda_device(s, "residual_ln_backward")
    for name, t, dtypes, nd in (("g", g, (torch.bfloat16,), 3), ("s", s, (torch.bfloat16,), 3),
                                ("mean", mean, (torch.float32,), 1), ("rstd", rstd, (torch.float32,), 1),
                                ("scale", scale, (torch.float32,), 1)):
        require(f"residual_ln_backward {name}", t, dtypes, nd, dev_t, align=16 if nd > 1 else 4)
    b, m, d = s.shape
    if g.shape != s.shape or mean.shape != (b * m,) or rstd.shape != (b * m,) or not 0 <= n_f <= m:
        raise ValueError(f"residual_ln_backward: g {tuple(g.shape)}, s {tuple(s.shape)}, mean {tuple(mean.shape)}, "
                         f"n_f {n_f} do not fit")
    lib = build.library()
    g_s = torch.empty_like(s)
    g_h = torch.empty((b, n_f * d), dtype=s.dtype, device=dev_t)
    g_scale = torch.empty((d,), dtype=torch.float32, device=dev_t)
    g_shift = torch.empty((d,), dtype=torch.float32, device=dev_t)
    partials = torch.empty((lib.rm_wukong_ln_partial_floats(b, m, d),), dtype=torch.float32, device=dev_t)
    dev, stream = device_and_stream(dev_t)
    err = lib.rm_wukong_ln_backward(dev, g.data_ptr(), s.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
                                    scale.data_ptr(), g_s.data_ptr(), g_h.data_ptr(), partials.data_ptr(),
                                    g_scale.data_ptr(), g_shift.data_ptr(), b, m, n_f, d, stream)
    build.check(err, "residual_ln_backward")
    residual_ln_backward.launches += 1
    return g_s, g_h, g_scale, g_shift


residual_ln_backward.launches = 0  # calls (two kernels each) since the count was last set to 0
