"""CUDA kernels for the xDeepFM forward and their plain PyTorch versions.

Counterpart of ``recmodels_tpu/ops/pallas/interactions_tpu.py`` for the
serving slice:

* ``split_fused_rows`` -> ``csrc/split_fused.cu`` (the TPU's
  ``_split_fused_fwd_impl``);
* ``cin2_forward`` -> ``csrc/cin2.cu`` (the TPU's ``_cin2_fwd_call``), reached
  through ``cin_stack_dm_flat`` for a 2-layer CIN in bf16.

Each entry point chooses by the device of the tensor it is given: a CPU
tensor takes the plain version, a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import torch

from recmodels_tpu_torch.ops import interactions
from recmodels_tpu_torch.ops.cuda import build
from recmodels_tpu_torch.ops.cuda.launch import cuda_device, device_and_stream, require

_NO_KERNEL = (
    "no CUDA kernel yet for this CIN configuration (only 2 layers in bf16): "
    "see ROADMAP.md, queue 2, the generic CIN layer kernels "
    "(interactions_tpu.py::_cin_forward_2d and _cin_bwd_pallas)"
)


# ------------------------------------------------------- fused-row fanout
split_fused_rows_reference = interactions.split_fused_rows


def split_fused_rows(full: torch.Tensor, emb_dim: int):
    """[B, m, D+1] rows (bf16 or f32) -> (x_dm [B, D, m] in the same dtype,
    wide_sum [B] f32)."""
    if full.device.type == "cpu":
        return split_fused_rows_reference(full, emb_dim)
    dev_t = cuda_device(full, "split_fused_rows")
    require("split_fused_rows rows", full, (torch.bfloat16, torch.float32), 3, dev_t)
    b, m, d1 = full.shape
    if d1 != emb_dim + 1:
        raise ValueError(f"split_fused_rows: rows of {d1}, expected emb_dim + 1 = {emb_dim + 1}")
    x_dm = torch.empty((b, emb_dim, m), dtype=full.dtype, device=dev_t)
    wide_sum = torch.empty((b,), dtype=torch.float32, device=dev_t)
    dev, stream = device_and_stream(dev_t)
    err = build.library().rm_split_fused_rows(
        dev, full.data_ptr(), x_dm.data_ptr(), wide_sum.data_ptr(), b, m, emb_dim,
        int(full.dtype == torch.bfloat16), stream,
    )
    build.check(err, "split_fused_rows")
    split_fused_rows.launches += 1
    return x_dm, wide_sum


split_fused_rows.launches = 0  # kernel launches since the count was last set to 0


# ------------------------------------------------------ fused 2-layer CIN
def cin2_forward_reference(x02: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
                           d: int, want_x1: bool = False, want_q: bool = False):
    """Plain version of the kernel, in the same pair-pool form and with the
    same rounding points (``csrc/cin2.cu`` has the formulas). x02 [B*d, m],
    w1 [m, m*h1], w2 [h1, m*h2] -> (x1 [B*d, h1] or None, p1 [B, h1],
    p2 [B, h2], Q [B, m*h1] or None), all in x02's dtype (in f32 nothing
    rounds between the steps)."""
    dt = x02.dtype
    rows, m = x02.shape
    b = rows // d
    h1 = w1.shape[1] // m
    h2 = w2.shape[1] // m
    x0 = x02.float()
    pairs = (x0[:, :, None] * x0[:, None, :]).reshape(rows, m * m).to(dt).float()
    x1 = (pairs @ w1.float().reshape(m * m, h1)).to(dt)
    x1f = x1.float().reshape(b, d, h1)
    p1 = x1f.sum(dim=1).to(dt)
    q = torch.einsum("bdj,bdk->bjk", x0.reshape(b, d, m), x1f).reshape(b, m * h1).to(dt)
    # W2R[(j, k), n] = w2[k, j*h2 + n]
    w2r = w2.float().reshape(h1, m, h2).transpose(0, 1).reshape(m * h1, h2)
    p2 = (q.float() @ w2r).to(dt)
    return (x1 if want_x1 else None), p1, p2, (q if want_q else None)


def cin2_forward(x02: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor, d: int,
                 want_x1: bool = False, want_q: bool = False):
    """Fused 2-layer CIN forward on bf16 rows: same arguments and results as
    ``cin2_forward_reference``. Any B; on CUDA, d <= 16 and h1, h2 multiples
    of 16 up to 128."""
    if x02.device.type == "cpu":
        return cin2_forward_reference(x02, w1, w2, d, want_x1, want_q)
    dev_t = cuda_device(x02, "cin2_forward")
    bf16 = (torch.bfloat16,)
    require("cin2_forward x0", x02, bf16, 2, dev_t)
    require("cin2_forward w1", w1, bf16, 2, dev_t, align=32)
    require("cin2_forward w2", w2, bf16, 2, dev_t, align=32)
    rows, m = x02.shape
    h1 = w1.shape[1] // m
    h2 = w2.shape[1] // m
    if rows % d or w1.shape != (m, m * h1) or w2.shape != (h1, m * h2):
        raise ValueError(
            f"cin2_forward: x0 {tuple(x02.shape)}, w1 {tuple(w1.shape)}, "
            f"w2 {tuple(w2.shape)} and d={d} do not fit together"
        )
    if d > 16 or h1 % 16 or h2 % 16 or not (16 <= h1 <= 128 and 16 <= h2 <= 128):
        raise NotImplementedError(
            f"cin2_forward kernel: d={d}, h1={h1}, h2={h2}; it takes d <= 16 and "
            "h1, h2 multiples of 16 up to 128"
        )
    b = rows // d

    def new(*shape):
        return torch.empty(shape, dtype=torch.bfloat16, device=dev_t)

    x1 = new(rows, h1) if want_x1 else None
    q = new(b, m * h1) if want_q else None
    p1, p2 = new(b, h1), new(b, h2)
    dev, stream = device_and_stream(dev_t)
    err = build.library().rm_cin2_forward(
        dev, x02.data_ptr(), w1.data_ptr(), w2.data_ptr(),
        None if x1 is None else x1.data_ptr(), p1.data_ptr(), p2.data_ptr(),
        None if q is None else q.data_ptr(), b, d, m, h1, h2, stream,
    )
    build.check(err, "cin2_forward")
    cin2_forward.launches += 1
    return x1, p1, p2, q


cin2_forward.launches = 0  # kernel launches since the count was last set to 0


def cin_stack_dm_flat(x0_dm: torch.Tensor, w2s) -> torch.Tensor:
    """CIN pools [B, sum(H)] from a D-major field matrix [B, D, m] and flat
    weights. Two layers in bf16 take ``cin2_forward``; other configurations
    run the plain ops on the CPU and have no CUDA kernel yet."""
    b, d, m = x0_dm.shape
    if len(w2s) != 2 or x0_dm.dtype != torch.bfloat16:
        if x0_dm.device.type == "cpu":
            return interactions.cin_stack_dm_flat(x0_dm, w2s)
        raise NotImplementedError(_NO_KERNEL)
    _, p1, p2, _ = cin2_forward(x0_dm.reshape(b * d, m), w2s[0], w2s[1], d)
    return torch.cat([p1, p2], dim=1)
