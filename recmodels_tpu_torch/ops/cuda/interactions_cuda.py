"""CUDA kernels for the xDeepFM forward and backward, and their plain PyTorch
versions.

Counterpart of ``recmodels_tpu/ops/pallas/interactions_tpu.py`` for the
serving and training slices:

* ``split_fused_rows`` -> ``csrc/split_fused.cu`` (the TPU's
  ``_split_fused_fwd_impl``), its backward ``split_fused_rows_backward`` in
  the same file (``_split_fused_bwd_impl``), joined by ``SplitFusedRows``;
* ``cin2_forward`` -> ``csrc/cin2.cu`` (``_cin2_fwd_call``) and
  ``cin2_backward`` -> ``csrc/cin2_bwd.cu`` (``_cin2_bwd_call``), joined by
  ``Cin2`` and reached through ``cin_stack_dm_flat`` for a 2-layer CIN in
  bf16.

Each entry point chooses by the device of the tensor it is given: a CPU
tensor takes the plain version, a CUDA tensor launches the kernel or raises.
The ``autograd.Function``s mirror the JAX package's custom VJPs.
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


def split_fused_rows_backward_reference(g_dm: torch.Tensor, g_ws: torch.Tensor) -> torch.Tensor:
    """Plain version of the fanout's backward: g_dm [B, D, m] and g_ws [B]
    f32 -> the rows' cotangent [B, m, D+1] in g_dm's dtype (g_dm transposed,
    g_ws cast and broadcast into the last column)."""
    b, d, m = g_dm.shape
    out = torch.empty((b, m, d + 1), dtype=g_dm.dtype, device=g_dm.device)
    out[..., :d] = g_dm.transpose(1, 2)
    out[..., d] = g_ws.to(g_dm.dtype)[:, None]
    return out


def split_fused_rows_backward(g_dm: torch.Tensor, g_ws: torch.Tensor) -> torch.Tensor:
    """Backward of ``split_fused_rows``: same arguments and result as
    ``split_fused_rows_backward_reference``."""
    if g_dm.device.type == "cpu":
        return split_fused_rows_backward_reference(g_dm, g_ws)
    dev_t = cuda_device(g_dm, "split_fused_rows_backward")
    require("split_fused_rows_backward g_dm", g_dm, (torch.bfloat16, torch.float32), 3, dev_t)
    require("split_fused_rows_backward g_ws", g_ws, (torch.float32,), 1, dev_t, align=4)
    b, d, m = g_dm.shape
    if g_ws.shape != (b,):
        raise ValueError(f"split_fused_rows_backward: g_ws {tuple(g_ws.shape)}, expected ({b},)")
    out = torch.empty((b, m, d + 1), dtype=g_dm.dtype, device=dev_t)
    dev, stream = device_and_stream(dev_t)
    err = build.library().rm_split_fused_rows_backward(
        dev, g_dm.data_ptr(), g_ws.data_ptr(), out.data_ptr(), b, m, d,
        int(g_dm.dtype == torch.bfloat16), stream,
    )
    build.check(err, "split_fused_rows_backward")
    split_fused_rows_backward.launches += 1
    return out


split_fused_rows_backward.launches = 0  # kernel launches since the count was last set to 0


class SplitFusedRows(torch.autograd.Function):
    """``split_fused_rows`` with its backward kernel (the JAX package's
    custom VJP, ``interactions_tpu.py`` 980-999): the rows' cotangent takes
    the dtype of x_dm's."""

    @staticmethod
    def forward(ctx, full: torch.Tensor, emb_dim: int):
        return split_fused_rows(full, emb_dim)

    @staticmethod
    def backward(ctx, g_dm, g_ws):
        return split_fused_rows_backward(g_dm.contiguous(), g_ws.float().contiguous()), None


def split_fused_rows_op(full: torch.Tensor, emb_dim: int):
    """The fanout as the model calls it: through ``SplitFusedRows`` when
    grads are wanted, else the forward alone."""
    if torch.is_grad_enabled() and full.requires_grad:
        return SplitFusedRows.apply(full, emb_dim)
    return split_fused_rows(full, emb_dim)


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


def cin2_backward_reference(x02, x1, w1, w2, q, g1p, g2p, d: int):
    """Plain version of the backward kernel, in the same pair-pool form and
    with the same rounding points (``csrc/cin2_bwd.cu`` has the formulas):
    the forward's x02 [B*d, m], x1 [B*d, h1] and Q [B, m*h1], the weights
    w1 [m, m*h1] and w2 [h1, m*h2], and the pool grads g1p [B, h1] and g2p
    [B, h2] -> (gx0 [B*d, m] in x02's dtype, gw1 and gw2 in the weights'
    dtypes). In f32 nothing rounds between the steps."""
    dt = x02.dtype
    rows, m = x02.shape
    b = rows // d
    h1 = w1.shape[1] // m
    h2 = w2.shape[1] // m

    def rnd(t):  # a rounding point of the kernel
        return t.to(dt).float()

    x0 = x02.float()
    x0b = x0.reshape(b, d, m)
    # layer 2: t1p[b, i, k] = sum_n g2p[b, n] * w2[k, i*h2 + n]
    w2t = w2.float().reshape(h1, m, h2).permute(2, 1, 0).reshape(h2, m * h1)
    t1p = rnd(g2p.float() @ w2t).reshape(b, m, h1)
    gx1 = rnd(torch.einsum("bik,bdi->bdk", t1p, x0b) + g1p.float()[:, None, :])
    gx0_a = rnd(t1p[:, None, :, :] * x1.float().reshape(b, d, 1, h1)).sum(-1)
    gw2 = (g2p.float().t() @ q.float()).reshape(h2, m, h1).permute(2, 1, 0).reshape(h1, m * h2)
    # layer 1, pair-first: gp[r, h, i] = sum_n gx1[r, n] * w1[h, i*h1 + n]
    gx1 = gx1.reshape(rows, h1)
    gp = rnd(gx1 @ w1.float().reshape(m * m, h1).t()).reshape(rows, m, m)
    gx0_b = rnd(gp * x0[:, None, :]).sum(2) + rnd(gp * x0[:, :, None]).sum(1)
    pairs = rnd(x0[:, :, None] * x0[:, None, :]).reshape(rows, m * m)
    gw1 = (pairs.t() @ gx1).reshape(m, m * h1)
    gx0 = (gx0_a.reshape(rows, m) + gx0_b).to(dt)
    return gx0, gw1.to(w1.dtype), gw2.to(w2.dtype)


def cin2_backward(x02, x1, w1, w2, q, g1p, g2p, d: int):
    """Fused 2-layer CIN backward on bf16 tensors: same arguments and
    results as ``cin2_backward_reference``. Any B; on CUDA, d <= 16, 4 <= m
    <= 32 and h1, h2 multiples of 16 up to 128."""
    if x02.device.type == "cpu":
        return cin2_backward_reference(x02, x1, w1, w2, q, g1p, g2p, d)
    dev_t = cuda_device(x02, "cin2_backward")
    bf16 = (torch.bfloat16,)
    rows, m = x02.shape
    h1 = w1.shape[1] // m
    h2 = w2.shape[1] // m
    b = rows // d
    for what, t, shape, align in (
        ("x0", x02, (rows, m), 16), ("x1", x1, (rows, h1), 16), ("w1", w1, (m, m * h1), 32),
        ("w2", w2, (h1, m * h2), 32), ("Q", q, (b, m * h1), 16), ("g1p", g1p, (b, h1), 16),
        ("g2p", g2p, (b, h2), 16),
    ):
        require(f"cin2_backward {what}", t, bf16, 2, dev_t, align=align)
        if tuple(t.shape) != shape or rows % d:
            raise ValueError(f"cin2_backward: {what} {tuple(t.shape)}, expected {shape} (d={d})")
    lib = build.library()
    scratch_bytes = lib.rm_cin2_backward_scratch(b, d, m, h1, h2)
    if scratch_bytes < 0:
        raise NotImplementedError(
            f"cin2_backward kernel: d={d}, m={m}, h1={h1}, h2={h2}; it takes d <= 16, "
            "4 <= m <= 32 and h1, h2 multiples of 16 up to 128"
        )
    gx0 = torch.empty((rows, m), dtype=torch.bfloat16, device=dev_t)
    gw1 = torch.empty((m, m * h1), dtype=torch.bfloat16, device=dev_t)
    gw2 = torch.empty((h1, m * h2), dtype=torch.bfloat16, device=dev_t)
    scratch = torch.empty((max(scratch_bytes, 1),), dtype=torch.uint8, device=dev_t)
    dev, stream = device_and_stream(dev_t)
    err = lib.rm_cin2_backward(
        dev, x02.data_ptr(), x1.data_ptr(), w1.data_ptr(), w2.data_ptr(), q.data_ptr(),
        g1p.data_ptr(), g2p.data_ptr(), gx0.data_ptr(), gw1.data_ptr(), gw2.data_ptr(),
        scratch.data_ptr(), b, d, m, h1, h2, stream,
    )
    build.check(err, "cin2_backward")
    cin2_backward.launches += 1
    return gx0, gw1, gw2


cin2_backward.launches = 0  # kernel launches since the count was last set to 0


class Cin2(torch.autograd.Function):
    """Pools (p1, p2) of the fused 2-layer CIN with its backward kernel (the
    JAX package's custom VJP, ``interactions_tpu.py`` 802-823): the forward
    saves x0, x1 and Q, the backward rounds the pool grads to bf16."""

    @staticmethod
    def forward(ctx, x02: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor, d: int):
        x1, p1, p2, q = cin2_forward(x02, w1, w2, d, want_x1=True, want_q=True)
        ctx.save_for_backward(x02, x1, w1, w2, q)
        ctx.d = d
        return p1, p2

    @staticmethod
    def backward(ctx, g1p, g2p):
        x02, x1, w1, w2, q = ctx.saved_tensors
        pools = (g.to(torch.bfloat16).contiguous() for g in (g1p, g2p))
        gx0, gw1, gw2 = cin2_backward(x02, x1, w1, w2, q, *pools, ctx.d)
        return gx0, gw1, gw2, None


def cin_stack_dm_flat(x0_dm: torch.Tensor, w2s) -> torch.Tensor:
    """CIN pools [B, sum(H)] from a D-major field matrix [B, D, m] and flat
    weights. Two layers in bf16 take ``cin2_forward``, through ``Cin2`` when
    grads are wanted; other configurations run the plain ops on the CPU and
    have no CUDA kernel yet."""
    b, d, m = x0_dm.shape
    if len(w2s) != 2 or x0_dm.dtype != torch.bfloat16:
        if x0_dm.device.type == "cpu":
            return interactions.cin_stack_dm_flat(x0_dm, w2s)
        raise NotImplementedError(_NO_KERNEL)
    x02 = x0_dm.reshape(b * d, m)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x02, *w2s)):
        p1, p2 = Cin2.apply(x02, w2s[0], w2s[1], d)
    else:
        _, p1, p2, _ = cin2_forward(x02, w2s[0], w2s[1], d)
    return torch.cat([p1, p2], dim=1)
