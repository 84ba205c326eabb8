"""CUDA kernels for the interaction ops (xDeepFM's fanout and CIN, the FM
term, the DCN cross stack), forward and backward, and their plain PyTorch
versions.

Counterpart of ``recmodels_tpu/ops/pallas/interactions_tpu.py``:

* ``split_fused_rows`` -> ``csrc/split_fused.cu`` (the TPU's
  ``_split_fused_fwd_impl``), its backward ``split_fused_rows_backward`` in
  the same file (``_split_fused_bwd_impl``), joined by ``SplitFusedRows``;
* ``cin2_forward`` -> ``csrc/cin2.cu`` (``_cin2_fwd_call``) and
  ``cin2_backward`` -> ``csrc/cin2_bwd.cu`` (``_cin2_bwd_call``), joined by
  ``Cin2`` and reached through ``cin_stack_dm_flat`` for a 2-layer CIN in
  bf16, its widths zero-padded to multiples of 16 where they are not
  (``cin2_route_widths``, ``cin2_pad_weights``);
* ``cin_layer_forward`` -> ``csrc/cin_layer.cu`` (``_cin_forward_2d``) and
  ``cin_layer_backward`` -> ``csrc/cin_layer_bwd.cu`` (``_cin_bwd_pallas``),
  joined by ``CinLayer2d``: every other CIN, one layer at a time;
* ``transpose_minor2`` -> ``csrc/transpose.cu`` (``_transpose_minor2``),
  its own backward in ``TransposeMinor2``;
* ``fm_pairwise_forward`` -> ``csrc/fm_pairwise.cu`` (``_fm_forward``) and
  ``dcn_cross_stack_forward`` -> ``csrc/dcn_cross.cu`` (``_dcn_forward``),
  joined to their backwards by ``FmPairwise`` and ``DcnCrossStack``. The
  JAX package has no Pallas backward for either: both backwards are its
  custom VJPs (``_fm_bwd``, ``_dcn_bwd``) in plain PyTorch ops, on the card
  too.

Each entry point chooses by the device of the tensor it is given: a CPU
tensor takes the plain version, a CUDA tensor launches the kernel or raises.
The ``autograd.Function``s mirror the JAX package's custom VJPs, and the CIN
ops at the end follow ``interactions_tpu.py``'s (``cin_layer`` ...
``cin_stack_dm_flat``).
"""

from __future__ import annotations

import torch

from recmodels_tpu_torch.ops import interactions
from recmodels_tpu_torch.ops.cuda import build
from recmodels_tpu_torch.ops.cuda.launch import cuda_device, device_and_stream, require
from recmodels_tpu_torch.utils import profiling

FLOAT_DTYPES = (torch.bfloat16, torch.float32)


# ------------------------------------------------------- fused-row fanout
split_fused_rows_reference = interactions.split_fused_rows

# an example's [m, D+1] rows are staged whole in a block's shared memory
SPLIT_FUSED_MAX_EXAMPLE_BYTES = 48 * 1024


def _check_example_bytes(what: str, m: int, d: int, dtype: torch.dtype) -> None:
    nbytes = m * (d + 1) * dtype.itemsize
    if nbytes > SPLIT_FUSED_MAX_EXAMPLE_BYTES:
        raise ValueError(f"{what} kernel: an example's rows [{m}, {d + 1}] of {dtype} take {nbytes} bytes; "
                         f"it takes examples within {SPLIT_FUSED_MAX_EXAMPLE_BYTES} bytes")


def split_fused_rows(full: torch.Tensor, emb_dim: int):
    """[B, m, D+1] rows (bf16 or f32) -> (x_dm [B, D, m] in the same dtype,
    wide_sum [B] f32). Any shape on the CPU; on CUDA an example's rows
    within ``SPLIT_FUSED_MAX_EXAMPLE_BYTES``."""
    if full.device.type == "cpu":
        return split_fused_rows_reference(full, emb_dim)
    dev_t = cuda_device(full, "split_fused_rows")
    require("split_fused_rows rows", full, (torch.bfloat16, torch.float32), 3, dev_t)
    b, m, d1 = full.shape
    if d1 != emb_dim + 1:
        raise ValueError(f"split_fused_rows: rows of {d1}, expected emb_dim + 1 = {emb_dim + 1}")
    _check_example_bytes("split_fused_rows", m, emb_dim, full.dtype)
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
    ``split_fused_rows_backward_reference``; on CUDA the same limit on an
    example."""
    if g_dm.device.type == "cpu":
        return split_fused_rows_backward_reference(g_dm, g_ws)
    dev_t = cuda_device(g_dm, "split_fused_rows_backward")
    require("split_fused_rows_backward g_dm", g_dm, (torch.bfloat16, torch.float32), 3, dev_t)
    require("split_fused_rows_backward g_ws", g_ws, (torch.float32,), 1, dev_t, align=4)
    b, d, m = g_dm.shape
    if g_ws.shape != (b,):
        raise ValueError(f"split_fused_rows_backward: g_ws {tuple(g_ws.shape)}, expected ({b},)")
    _check_example_bytes("split_fused_rows_backward", m, d, g_dm.dtype)
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


CIN2_MAX_D = 32  # an example's rows fill 16 or 32 slots of a 128-slot tile
CIN2_MAX_M = 32  # pairs (h, i) with i padded to 32
CIN2_MAX_H = 256  # the widest wgmma product: N = 256


def cin2_takes(d: int, m: int, h1: int, h2: int, dtype: torch.dtype) -> bool:
    """Whether the fused kernels (``csrc/cin2.cu``, ``csrc/cin2_bwd.cu``)
    take a two-layer CIN of d rows per example, m fields and layer widths h1,
    h2 in ``dtype``: bf16, d and m up to 32, h1 and h2 multiples of 16 from
    16 to 256. ``cin_stack_dm_flat`` routes by it on every device; the
    kernels' own check (``rm_cin2_takes``) is the same."""
    return (dtype == torch.bfloat16 and 1 <= d <= CIN2_MAX_D and 1 <= m <= CIN2_MAX_M
            and all(h % 16 == 0 and 16 <= h <= CIN2_MAX_H for h in (h1, h2)))


def cin2_route_widths(d: int, m: int, h1: int, h2: int, dtype: torch.dtype):
    """The widths (h1', h2') at which ``cin_stack_dm_flat`` runs a two-layer
    CIN through the fused kernels, or None where it goes layer by layer:
    each width rounded up to a multiple of 16, if ``cin2_takes`` admits the
    rounded shape. Widths that are multiples of 16 come back as they are."""
    widths = (-(-h1 // 16) * 16, -(-h2 // 16) * 16)
    return widths if cin2_takes(d, m, *widths, dtype) else None


def cin2_pad_weights(w1: torch.Tensor, w2: torch.Tensor, m: int, h1p: int, h2p: int):
    """Flat weights w1 [m, m*h1] and w2 [h1, m*h2] zero-padded to the widths
    h1p >= h1 and h2p >= h2: w1 [m, m*h1p] (output columns n >= h1 zero), w2
    [h1p, m*h2p] (rows k >= h1 and output columns n >= h2 zero). The padded
    channels of x1, p1, Q and p2 are then exact zeros that add nothing to
    any f32 sum, and the padded weights' gradients are zero. A differentiable
    op: autograd hands the gradients back cut to w1's and w2's shapes."""
    h1, h2 = w1.shape[1] // m, w2.shape[1] // m
    w1p = torch.nn.functional.pad(w1.reshape(m, m, h1), (0, h1p - h1))
    w2p = torch.nn.functional.pad(w2.reshape(h1, m, h2), (0, h2p - h2, 0, 0, 0, h1p - h1))
    return w1p.reshape(m, m * h1p), w2p.reshape(h1p, m * h2p)


def _cin2_refusal(what: str, d: int, m: int, h1: int, h2: int) -> NotImplementedError:
    return NotImplementedError(
        f"{what} kernel: d={d}, m={m}, h1={h1}, h2={h2}; it takes d <= {CIN2_MAX_D}, m <= "
        f"{CIN2_MAX_M} and h1, h2 multiples of 16 up to {CIN2_MAX_H} (cin2_takes)")


def cin2_forward(x02: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor, d: int,
                 want_x1: bool = False, want_q: bool = False):
    """Fused 2-layer CIN forward on bf16 rows: same arguments and results as
    ``cin2_forward_reference``. Any B; on CUDA, the shapes ``cin2_takes``
    admits."""
    if x02.device.type == "cpu":
        return cin2_forward_reference(x02, w1, w2, d, want_x1, want_q)
    dev_t = cuda_device(x02, "cin2_forward")
    bf16 = (torch.bfloat16,)
    require("cin2_forward x0", x02, bf16, 2, dev_t)
    require("cin2_forward w1", w1, bf16, 2, dev_t)
    require("cin2_forward w2", w2, bf16, 2, dev_t)
    rows, m = x02.shape
    h1 = w1.shape[1] // m
    h2 = w2.shape[1] // m
    if rows % d or w1.shape != (m, m * h1) or w2.shape != (h1, m * h2):
        raise ValueError(
            f"cin2_forward: x0 {tuple(x02.shape)}, w1 {tuple(w1.shape)}, "
            f"w2 {tuple(w2.shape)} and d={d} do not fit together"
        )
    if not cin2_takes(d, m, h1, h2, x02.dtype):
        raise _cin2_refusal("cin2_forward", d, m, h1, h2)
    b = rows // d

    def new(*shape):
        return torch.empty(shape, dtype=torch.bfloat16, device=dev_t)

    x1 = new(rows, h1) if want_x1 else None
    q = new(b, m * h1) if want_q else None
    p1, p2 = new(b, h1), new(b, h2)
    lib = build.library()
    scratch = torch.empty((max(lib.rm_cin2_forward_scratch(b, d, m, h1, h2, int(want_q)), 1),),
                          dtype=torch.uint8, device=dev_t)
    dev, stream = device_and_stream(dev_t)
    err = lib.rm_cin2_forward(
        dev, x02.data_ptr(), w1.data_ptr(), w2.data_ptr(),
        None if x1 is None else x1.data_ptr(), p1.data_ptr(), p2.data_ptr(),
        None if q is None else q.data_ptr(), scratch.data_ptr(), b, d, m, h1, h2, stream,
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
    results as ``cin2_backward_reference``. Any B; on CUDA, the shapes
    ``cin2_takes`` admits."""
    if x02.device.type == "cpu":
        return cin2_backward_reference(x02, x1, w1, w2, q, g1p, g2p, d)
    dev_t = cuda_device(x02, "cin2_backward")
    bf16 = (torch.bfloat16,)
    rows, m = x02.shape
    h1 = w1.shape[1] // m
    h2 = w2.shape[1] // m
    b = rows // d
    for what, t, shape in (
        ("x0", x02, (rows, m)), ("x1", x1, (rows, h1)), ("w1", w1, (m, m * h1)),
        ("w2", w2, (h1, m * h2)), ("Q", q, (b, m * h1)), ("g1p", g1p, (b, h1)), ("g2p", g2p, (b, h2)),
    ):
        require(f"cin2_backward {what}", t, bf16, 2, dev_t)
        if tuple(t.shape) != shape or rows % d:
            raise ValueError(f"cin2_backward: {what} {tuple(t.shape)}, expected {shape} (d={d})")
    if not cin2_takes(d, m, h1, h2, x02.dtype):
        raise _cin2_refusal("cin2_backward", d, m, h1, h2)
    lib = build.library()
    dev, stream = device_and_stream(dev_t)
    scratch_bytes = lib.rm_cin2_backward_scratch(dev, b, d, m, h1, h2)
    if scratch_bytes < 0:
        raise RuntimeError(f"cin2_backward: no scratch size for device {dev}")
    gx0 = torch.empty((rows, m), dtype=torch.bfloat16, device=dev_t)
    gw1 = torch.empty((m, m * h1), dtype=torch.bfloat16, device=dev_t)
    gw2 = torch.empty((h1, m * h2), dtype=torch.bfloat16, device=dev_t)
    scratch = torch.empty((max(scratch_bytes, 1),), dtype=torch.uint8, device=dev_t)
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


# ------------------------------------------------------- transpose_minor2
def transpose_minor2_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain version: [B, a, b] -> [B, b, a], contiguous."""
    return x.transpose(1, 2).contiguous()


TRANSPOSE_MAX_ITEM_BYTES = 64 * 1024  # an [a, b] item sits whole in a block's shared memory


def transpose_minor2(x: torch.Tensor) -> torch.Tensor:
    """[B, a, b] -> [B, b, a] (bf16 or f32), contiguous. Any shape on the
    CPU; on CUDA an [a, b] item of at most ``TRANSPOSE_MAX_ITEM_BYTES``:
    a field matrix of m slots x D up to 16,384 f32 elements (256 x 64),
    and, since ``cin_layer`` also transposes xk [B, Hk, D] and its output
    [B, D, Hn], a CIN layer with Hk·D and Hn·D up to 16,384 in f32 (32,768
    in bf16)."""
    if x.device.type == "cpu":
        return transpose_minor2_reference(x)
    dev_t = cuda_device(x, "transpose_minor2")
    require("transpose_minor2 x", x, FLOAT_DTYPES, 3, dev_t, align=x.element_size())
    bsz, a, b = x.shape
    item_bytes = a * b * x.element_size()
    if item_bytes > TRANSPOSE_MAX_ITEM_BYTES:
        raise ValueError(f"transpose_minor2 kernel: an item [{a}, {b}] of {x.dtype} takes {item_bytes} "
                         f"bytes; it takes items within {TRANSPOSE_MAX_ITEM_BYTES} bytes")
    out = torch.empty((bsz, b, a), dtype=x.dtype, device=dev_t)
    dev, stream = device_and_stream(dev_t)
    err = build.library().rm_transpose_minor2(dev, x.data_ptr(), out.data_ptr(), bsz, a, b,
                                              x.element_size(), stream)
    build.check(err, "transpose_minor2")
    transpose_minor2.launches += 1
    return out


transpose_minor2.launches = 0  # kernel launches since the count was last set to 0


class TransposeMinor2(torch.autograd.Function):
    """``transpose_minor2`` whose backward is the same kernel on the
    cotangent (the JAX package's VJP, ``interactions_tpu.py`` 201-210)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor):
        return transpose_minor2(x)

    @staticmethod
    def backward(ctx, g):
        return transpose_minor2(g.contiguous())


def transpose_minor2_op(x: torch.Tensor) -> torch.Tensor:
    """The transpose as the CIN ops call it: through ``TransposeMinor2``
    when grads are wanted, else the forward alone."""
    x = x.contiguous()
    if torch.is_grad_enabled() and x.requires_grad:
        return TransposeMinor2.apply(x)
    return transpose_minor2(x)


# ------------------------------------------------------- generic CIN layer
def _layer_shapes(xk2: torch.Tensor, x02: torch.Tensor, w2: torch.Tensor, what: str):
    rows, hk = xk2.shape
    m = x02.shape[1]
    hn = w2.shape[1] // m
    if x02.shape[0] != rows or w2.shape != (hk, m * hn) or hn < 1:
        raise ValueError(f"{what}: xk {tuple(xk2.shape)}, x0 {tuple(x02.shape)} and "
                         f"w2 {tuple(w2.shape)} do not fit together")
    return rows, hk, m, hn


def cin_layer_forward_reference(xk2: torch.Tensor, x02: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """Plain version of one CIN layer on rows r = (b, d): xk2 [R, Hk], x02
    [R, m], flat w2 [Hk, m*Hn] -> [R, Hn] in xk2's dtype. t = xk @ w2 and
    the fold over i in f32, one cast at the end (``_cin_forward_2d``)."""
    rows, hk, m, hn = _layer_shapes(xk2, x02, w2, "cin_layer_forward")
    t = torch.einsum("rh,hin->rin", xk2.float(), w2.float().reshape(hk, m, hn))
    return torch.einsum("rin,ri->rn", t, x02.float()).to(xk2.dtype)


def cin_layer_forward(xk2: torch.Tensor, x02: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """One CIN layer: same arguments and result as
    ``cin_layer_forward_reference``; bf16 or f32, any sizes."""
    if xk2.device.type == "cpu":
        return cin_layer_forward_reference(xk2, x02, w2)
    dev_t = cuda_device(xk2, "cin_layer_forward")
    rows, hk, m, hn = _layer_shapes(xk2, x02, w2, "cin_layer_forward")
    dt = xk2.dtype
    for what, t in (("xk", xk2), ("x0", x02), ("w2", w2)):
        require(f"cin_layer_forward {what}", t, FLOAT_DTYPES, 2, dev_t, align=t.element_size())
        if t.dtype != dt:
            raise TypeError(f"cin_layer_forward: {what} is {t.dtype}, xk is {dt}")
    lib = build.library()
    is_bf16 = int(dt == torch.bfloat16)
    # bf16: scratch for padded copies of inputs the kernel's TMA cannot read as they lie
    scratch_bytes = lib.rm_cin_layer_forward_scratch(xk2.data_ptr(), w2.data_ptr(), rows, hk, m, hn, is_bf16)
    scratch = torch.empty((max(scratch_bytes, 1),), dtype=torch.uint8, device=dev_t)
    out = torch.empty((rows, hn), dtype=dt, device=dev_t)
    dev, stream = device_and_stream(dev_t)
    err = lib.rm_cin_layer_forward(
        dev, xk2.data_ptr(), x02.data_ptr(), w2.data_ptr(), out.data_ptr(), scratch.data_ptr(), rows, hk,
        m, hn, is_bf16, stream,
    )
    build.check(err, "cin_layer_forward")
    cin_layer_forward.launches += 1
    return out


cin_layer_forward.launches = 0  # kernel launches since the count was last set to 0


def cin_layer_backward_reference(xk2, x02, w2, g):
    """Plain version of the layer's backward kernel, with its rounding
    points (``csrc/cin_layer_bwd.cu`` has the formulas): the forward's xk2
    [R, Hk], x02 [R, m], w2 [Hk, m*Hn] and the output's cotangent g [R, Hn]
    -> (gxk [R, Hk] and gx0 [R, m] in xk2's dtype, gw [Hk, m*Hn] in w2's)."""
    rows, hk, m, hn = _layer_shapes(xk2, x02, w2, "cin_layer_backward")
    dt = xk2.dtype

    def rnd(t):  # a rounding point of the kernel
        return t.to(dt).float()

    xk, x0 = xk2.float(), x02.float()
    t1 = rnd(torch.einsum("rn,hin->rih", g.float(), w2.float().reshape(hk, m, hn)))
    gxk = torch.einsum("rih,ri->rh", t1, x0).to(dt)
    gx0 = rnd(t1 * xk[:, None, :]).sum(-1).to(dt)
    z = rnd(xk[:, None, :] * x0[:, :, None])  # [R, m, Hk]
    gw = torch.einsum("rih,rn->hin", z, g.float()).reshape(hk, m * hn)
    return gxk, gx0, gw.to(w2.dtype)


def cin_layer_backward(xk2, x02, w2, g):
    """The layer's backward kernel on bf16 tensors: same arguments and
    results as ``cin_layer_backward_reference``; any R and Hk, any Hn, and m
    as far as the rows kernel's shared memory holds 512 m bytes of partials
    a tile beside its other tiles: m up to 291 at Hn up to 64, 259 from 65
    to 128, 227 from 129 to 192, 195 from 193 to 256, 259 above 256 (the
    source note of ``csrc/cin_layer_bwd.cu``)."""
    if xk2.device.type == "cpu":
        return cin_layer_backward_reference(xk2, x02, w2, g)
    dev_t = cuda_device(xk2, "cin_layer_backward")
    rows, hk, m, hn = _layer_shapes(xk2, x02, w2, "cin_layer_backward")
    bf16 = (torch.bfloat16,)
    for what, t in (("xk", xk2), ("x0", x02), ("w2", w2), ("g", g)):
        require(f"cin_layer_backward {what}", t, bf16, 2, dev_t, align=2)
    if g.shape != (rows, hn):
        raise ValueError(f"cin_layer_backward: g {tuple(g.shape)}, expected {(rows, hn)}")
    lib = build.library()
    dev, stream = device_and_stream(dev_t)
    scratch_bytes = lib.rm_cin_layer_backward_scratch(
        dev, g.data_ptr(), xk2.data_ptr(), w2.data_ptr(), rows, hk, m, hn,
    )
    if scratch_bytes < 0:
        raise NotImplementedError(f"cin_layer_backward kernel: rows={rows}, hk={hk}, m={m}, hn={hn}; "
                                  "it takes m up to 291 at Hn up to 64, 259 from 65 to 128, 227 from "
                                  "129 to 192, 195 from 193 to 256, 259 above 256")
    gxk = torch.empty((rows, hk), dtype=torch.bfloat16, device=dev_t)
    gx0 = torch.empty((rows, m), dtype=torch.bfloat16, device=dev_t)
    gw = torch.empty((hk, m * hn), dtype=torch.bfloat16, device=dev_t)
    scratch = torch.empty((max(scratch_bytes, 1),), dtype=torch.uint8, device=dev_t)
    err = lib.rm_cin_layer_backward(
        dev, g.data_ptr(), xk2.data_ptr(), x02.data_ptr(), w2.data_ptr(), gxk.data_ptr(),
        gx0.data_ptr(), gw.data_ptr(), scratch.data_ptr(), rows, hk, m, hn, stream,
    )
    build.check(err, "cin_layer_backward")
    cin_layer_backward.launches += 1
    return gxk, gx0, gw


cin_layer_backward.launches = 0  # kernel launches since the count was last set to 0

BWD_ROWS = 512  # the JAX package's BWD_TR: its kernel takes whole 512-row tiles


def takes_backward_kernel(xk2: torch.Tensor, x02: torch.Tensor, w2: torch.Tensor) -> bool:
    """The JAX package's condition for ``_cin_bwd_pallas``
    (``interactions_tpu.py`` 433-436): aligned bf16 layers. Every other
    layer (layer 1, where Hk = m; f32) takes its einsum formulation."""
    rows, hk = xk2.shape
    m = x02.shape[1]
    hn = w2.shape[1] // m
    return (xk2.dtype == torch.bfloat16 and hk % 128 == 0 and hn % 128 == 0 and m <= 128
            and rows % BWD_ROWS == 0)


def cin_layer_backward_einsum(xk2, x02, w2, g):
    """The JAX package's einsum backward (``interactions_tpu.py`` 445-449)
    in the layer's dtype, each contraction in two steps so that no
    [R, Hk, Hn] intermediate forms: (gxk, gx0, gw)."""
    rows, hk, m, hn = _layer_shapes(xk2, x02, w2, "cin_layer_backward_einsum")
    w3 = w2.reshape(hk, m, hn)
    u = torch.einsum("rn,hin->rhi", g, w3)
    gxk = torch.einsum("rhi,ri->rh", u, x02)
    gx0 = torch.einsum("rhi,rh->ri", u, xk2)
    z = torch.einsum("rh,ri->rhi", xk2, x02)
    gw = torch.einsum("rhi,rn->hin", z, g)
    return gxk, gx0, gw.reshape(hk, m * hn).to(w2.dtype)


class CinLayer2d(torch.autograd.Function):
    """One CIN layer with the JAX package's custom VJP (``_cin_layer_2d``):
    the forward kernel saves xk2, x02 and w2; the backward takes the
    backward kernel where JAX takes its Pallas kernel, else the einsums."""

    @staticmethod
    def forward(ctx, xk2: torch.Tensor, x02: torch.Tensor, w2: torch.Tensor):
        ctx.save_for_backward(xk2, x02, w2)
        return cin_layer_forward(xk2, x02, w2)

    @staticmethod
    def backward(ctx, g):
        xk2, x02, w2 = ctx.saved_tensors
        g = g.to(xk2.dtype).contiguous()
        if takes_backward_kernel(xk2, x02, w2):
            return cin_layer_backward(xk2, x02, w2, g)
        return cin_layer_backward_einsum(xk2, x02, w2, g)


def cin_layer_2d(xk2: torch.Tensor, x02: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """One layer as the CIN ops call it: through ``CinLayer2d`` when grads
    are wanted, else the forward kernel alone."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (xk2, x02, w2)):
        return CinLayer2d.apply(xk2, x02, w2)
    return cin_layer_forward(xk2, x02, w2)


# ------------------------------------------------------------------ CIN ops
def cin2_pools(x02: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor, d: int, widths):
    """Pools (p1 [B, h1], p2 [B, h2]) of a two-layer CIN through the fused
    kernels (``Cin2`` when grads are wanted, else the forward alone) at
    ``widths`` (h1', h2') >= (h1, h2). Where they differ the weights are
    zero-padded (``cin2_pad_weights``) and the pools cut back to h1 and h2,
    both inside autograd, and the counter ``cin.fused_padded``
    (``utils/profiling.py``) goes up by one; where they are equal the
    weights go in as they are."""
    m = x02.shape[1]
    h1, h2 = w1.shape[1] // m, w2.shape[1] // m
    padded = tuple(widths) != (h1, h2)
    if padded:
        profiling.count("cin.fused_padded", 1)
        w1, w2 = cin2_pad_weights(w1, w2, m, *widths)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x02, w1, w2)):
        p1, p2 = Cin2.apply(x02, w1, w2, d)
    else:
        _, p1, p2, _ = cin2_forward(x02, w1, w2, d)
    return (p1[:, :h1], p2[:, :h2]) if padded else (p1, p2)


def cin_stack_dm_flat(x0_dm: torch.Tensor, w2s) -> torch.Tensor:
    """CIN pools [B, sum(H)] from a D-major field matrix [B, D, m] and flat
    weights [H_k, m*H_next]. Two layers that ``cin2_route_widths`` admits
    take the fused kernels (``cin2_pools``), at widths rounded up to
    multiples of 16 where they are not; every other CIN runs layer by layer
    (``CinLayer2d``), each layer's pool the sum over D in the activation
    dtype. The route depends on shapes and dtype alone, so the CPU takes the
    plain versions of the kernels the card runs."""
    b, d, m = x0_dm.shape
    x02 = x0_dm.reshape(b * d, m)
    if len(w2s) == 2:
        h1, h2 = (w.shape[1] // m for w in w2s)
        widths = cin2_route_widths(d, m, h1, h2, x0_dm.dtype)
        if widths is not None:
            return torch.cat(cin2_pools(x02, w2s[0], w2s[1], d, widths), dim=1)
    xk2 = x02
    pools = []
    for w2 in w2s:
        xk2 = cin_layer_2d(xk2, x02, w2)
        pools.append(xk2.reshape(b, d, -1).sum(dim=1))
    return torch.cat(pools, dim=1)


def cin_stack_flat(x0: torch.Tensor, w2s) -> torch.Tensor:
    """``cin_stack_dm_flat`` from an H-major field matrix x0 [B, m, D]."""
    return cin_stack_dm_flat(transpose_minor2_op(x0), w2s)


def cin_stack_dm(x0_dm: torch.Tensor, ws) -> torch.Tensor:
    """``cin_stack_dm_flat`` with 3-D weights [H_next, H_k, m], flattened
    at the call."""
    return cin_stack_dm_flat(x0_dm, [interactions.flatten_cin_w(w) for w in ws])


def cin_stack(x0: torch.Tensor, ws) -> torch.Tensor:
    """The whole CIN from x0 [B, m, D] and 3-D weights: pools [B, sum(H)]."""
    return cin_stack_dm(transpose_minor2_op(x0), ws)


def cin_layer(xk: torch.Tensor, x0: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """One layer in the H-major layout: xk [B, H_k, D], x0 [B, m, D], w
    [H_next, H_k, m] -> [B, H_next, D]."""
    b, hk, d = xk.shape
    m = x0.shape[1]
    xk2 = transpose_minor2_op(xk).reshape(b * d, hk)
    x02 = transpose_minor2_op(x0).reshape(b * d, m)
    out2 = cin_layer_2d(xk2, x02, interactions.flatten_cin_w(w))
    return transpose_minor2_op(out2.reshape(b, d, w.shape[0]))


# ------------------------------------------------------------ FM pairwise
fm_pairwise_forward_reference = interactions.fm_pairwise


def fm_pairwise_forward(emb: torch.Tensor) -> torch.Tensor:
    """The FM second-order term: emb [B, F, D] (bf16 or f32) -> [B] in emb's
    dtype, the plain version's function and rounding points. On CUDA emb
    may be any view with unit stride along D (the engine's ``full[..., :D]``
    of gathered fused rows goes in as it is); the kernel takes its strides."""
    if emb.device.type == "cpu":
        return fm_pairwise_forward_reference(emb)
    dev_t = cuda_device(emb, "fm_pairwise")
    if emb.dtype not in FLOAT_DTYPES:
        raise TypeError(f"fm_pairwise emb: dtype {emb.dtype}, expected one of {FLOAT_DTYPES}")
    if emb.dim() != 3:
        raise ValueError(f"fm_pairwise emb: shape {tuple(emb.shape)}, expected 3 dimensions")
    b, f, d = emb.shape
    if d > 1 and emb.stride(2) != 1:
        raise ValueError(f"fm_pairwise emb: strides {emb.stride()}, the kernel needs unit stride along D")
    out = torch.empty((b,), dtype=emb.dtype, device=dev_t)
    dev, stream = device_and_stream(dev_t)
    err = build.library().rm_fm_pairwise(
        dev, emb.data_ptr(), out.data_ptr(), b, f, d, emb.stride(0), emb.stride(1),
        int(emb.dtype == torch.bfloat16), stream,
    )
    build.check(err, "fm_pairwise")
    fm_pairwise_forward.launches += 1
    return out


fm_pairwise_forward.launches = 0  # kernel launches since the count was last set to 0


def fm_pairwise_backward(emb: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """JAX's ``_fm_bwd``: d/de_fd = (s_d - e_fd) * g with s = sum_f e_f
    (rounded to emb's dtype like the forward's s): [B, F, D] in emb's dtype."""
    s = emb.float().sum(dim=1, keepdim=True).to(emb.dtype)
    return (s - emb) * g.to(emb.dtype)[:, None, None]


class FmPairwise(torch.autograd.Function):
    """``fm_pairwise_forward`` with JAX's custom VJP (``interactions_tpu.py``
    69-84): the forward saves emb, the backward is ``fm_pairwise_backward``."""

    @staticmethod
    def forward(ctx, emb: torch.Tensor):
        ctx.save_for_backward(emb)
        return fm_pairwise_forward(emb)

    @staticmethod
    def backward(ctx, g):
        (emb,) = ctx.saved_tensors
        return fm_pairwise_backward(emb, g)


def fm_pairwise_op(emb: torch.Tensor) -> torch.Tensor:
    """The FM term as the models call it: through ``FmPairwise`` when grads
    are wanted, else the forward alone."""
    if torch.is_grad_enabled() and emb.requires_grad:
        return FmPairwise.apply(emb)
    return fm_pairwise_forward(emb)


# -------------------------------------------------------- DCN cross stack
dcn_cross_stack_forward_reference = interactions.dcn_cross_stack

DCN_MAX_D = 1024  # the register path: a lane holds at most 32 of a row's values
DCN_SMEM_BYTES = 48 * 1024  # and w and b of every layer sit in shared memory
DCN_WIDE_THREADS = 256  # the wide path: one block of 256 threads per row


def dcn_rows_in_registers(d: int, n_layers: int, dtype: torch.dtype) -> bool:
    """Which of ``csrc/dcn_cross.cu``'s two paths takes x0 [B, d] with L
    layers: a warp per row with the row in registers (d <= ``DCN_MAX_D``,
    w and b within ``DCN_SMEM_BYTES``; DCN's d = 429 up to 28 bf16 or 14 f32
    layers), else a block per row."""
    itemsize = torch.finfo(dtype).bits // 8
    return d <= DCN_MAX_D and 2 * n_layers * d * itemsize <= DCN_SMEM_BYTES


def dcn_cross_stack_forward(x0: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """All L cross layers in one launch: x0 [B, d], w, b [L, d] (one dtype,
    bf16 or f32) -> x_L [B, d], the plain version's function and rounding
    points. Any B, d and L (``dcn_rows_in_registers`` says which path of
    the kernel runs)."""
    if x0.device.type == "cpu":
        return dcn_cross_stack_forward_reference(x0, w, b)
    dev_t = cuda_device(x0, "dcn_cross_stack")
    for what, t in (("x0", x0), ("w", w), ("b", b)):
        require(f"dcn_cross_stack {what}", t, FLOAT_DTYPES, 2, dev_t, align=t.element_size())
        if t.dtype != x0.dtype:
            raise TypeError(f"dcn_cross_stack: {what} is {t.dtype}, x0 is {x0.dtype}")
    bsz, d = x0.shape
    n_layers = w.shape[0]
    if w.shape[1] != d or b.shape != w.shape:
        raise ValueError(f"dcn_cross_stack: x0 {tuple(x0.shape)}, w {tuple(w.shape)} and "
                         f"b {tuple(b.shape)} do not fit together")
    out = torch.empty_like(x0)
    dev, stream = device_and_stream(dev_t)
    err = build.library().rm_dcn_cross_stack(
        dev, x0.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), bsz, d, n_layers,
        int(x0.dtype == torch.bfloat16), stream,
    )
    build.check(err, "dcn_cross_stack")
    dcn_cross_stack_forward.launches += 1
    return out


dcn_cross_stack_forward.launches = 0  # kernel launches since the count was last set to 0


def dcn_cross_stack_scale(x0: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per element of x_L, the size of what the layers added into it:
    ``|x0| * (1 + sum_l |t_l|) + sum_l |b_l|`` [B, d] f64, t_l from the
    plain chain. The checks hold the kernel to a share of it element by
    element: a t that rounds one step apart moves x0 * t by a step of t, and
    the next layer's t by that times x0 . w, while x_L itself may cancel or
    be one of the heavy-tailed products (1 + t_0)(1 + t_1)..."""
    xl, t_sum = x0, torch.zeros(x0.shape[0], dtype=torch.float64, device=x0.device)
    for layer in range(w.shape[0]):
        t_sum += (xl.float() @ w[layer].float()).to(x0.dtype).double().abs()
        xl = interactions.dcn_cross_layer(x0, xl, w[layer], b[layer])
    return x0.double().abs() * (1 + t_sum)[:, None] + b.double().abs().sum(0)[None, :]


def dcn_cross_stack_in_kernel_order(x0: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The plain version with each t = x_l . w_l summed as the kernel sums
    it. On the register path (``dcn_rows_in_registers``) lane j adds the
    products of columns j, j + 32, ... in turn, then the warp adds its 32
    partial sums by xor halving (16, 8, 4, 2, 1). On the wide path thread j
    of 256 adds columns j, j + 256, ..., each warp halves its 32 sums the same
    way, and the eight warp sums are added in warp order. In bf16 the
    products are exact in f32, so this is the kernel's result bit for bit;
    in f32 it rounds each product where the kernel's fmaf does not. For
    checks."""
    bsz, d = x0.shape
    threads = 32 if dcn_rows_in_registers(d, w.shape[0], x0.dtype) else DCN_WIDE_THREADS
    pad = -d % threads
    lanes = torch.arange(32, device=x0.device)
    xl = x0
    for layer in range(w.shape[0]):
        prods = (torch.nn.functional.pad(xl.float(), (0, pad))
                 * torch.nn.functional.pad(w[layer].float(), (0, pad))).reshape(bsz, -1, threads)
        acc = torch.zeros((bsz, threads), device=x0.device)
        for k in range(prods.shape[1]):
            acc = acc + prods[:, k]
        acc = acc.reshape(bsz, threads // 32, 32)
        for o in (16, 8, 4, 2, 1):
            acc = acc + acc[:, :, lanes ^ o]
        t = acc[:, 0, 0]
        for warp in range(1, threads // 32):
            t = t + acc[:, warp, 0]
        xl = x0 * t.to(x0.dtype)[:, None] + b[layer][None, :] + xl
    return xl


def dcn_cross_stack_backward(x0: torch.Tensor, w: torch.Tensor, b: torch.Tensor, g: torch.Tensor):
    """JAX's ``_dcn_bwd``: recompute the chain x_0 .. x_{L-1} with the plain
    layer, then walk it back. (gx0, gw, gb) in the inputs' dtypes; in bf16
    every sum adds in f32 and rounds once, as JAX's ``jnp.sum`` and
    ``einsum`` do."""
    dt = x0.dtype
    xs = [x0]
    for layer in range(w.shape[0] - 1):
        xs.append(interactions.dcn_cross_layer(x0, xs[-1], w[layer], b[layer]))
    gx0 = torch.zeros_like(x0)
    gw = torch.zeros_like(w)
    gb = torch.zeros_like(b)
    gxl = g.to(dt)
    for layer in range(w.shape[0] - 1, -1, -1):
        xl_in, wl = xs[layer], w[layer]
        t = (xl_in.float() @ wl.float()).to(dt)
        gb[layer] = gxl.float().sum(dim=0).to(dt)
        gt = (gxl * x0).float().sum(dim=1).to(dt)
        gx0 = gx0 + gxl * t[:, None]
        gw[layer] = (gt.float() @ xl_in.float()).to(dt)
        gxl = gxl + gt[:, None] * wl[None, :]
    return gx0 + gxl, gw, gb


class DcnCrossStack(torch.autograd.Function):
    """``dcn_cross_stack_forward`` with JAX's custom VJP
    (``interactions_tpu.py`` 125-161): the forward saves x0, w and b, the
    backward is ``dcn_cross_stack_backward``."""

    @staticmethod
    def forward(ctx, x0: torch.Tensor, w: torch.Tensor, b: torch.Tensor):
        ctx.save_for_backward(x0, w, b)
        return dcn_cross_stack_forward(x0, w, b)

    @staticmethod
    def backward(ctx, g):
        return dcn_cross_stack_backward(*ctx.saved_tensors, g)


def dcn_cross_stack_op(x0: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The cross stack as the models call it: through ``DcnCrossStack``
    when grads are wanted, else the forward alone."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x0, w, b)):
        return DcnCrossStack.apply(x0, w, b)
    return dcn_cross_stack_forward(x0, w, b)
