"""The port's CUDA kernels against their plain PyTorch versions, and its
paths (steps, scorer, eval, CLIs, sharded steps) against the CPU's plain
path and against their eager selves, on the card.

These need an NVIDIA GPU (the kernels have no CPU mode) and skip elsewhere.
The file imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Small and ragged shapes here; ``chip_smoke.py`` times the kernels at the
flagship shapes.
"""

import contextlib
import faulthandler
import os
import re
import sys

import numpy as np
import pytest
import torch

from recmodels_tpu_torch.embedding.bag import bag_gather, bag_gather_reference
from recmodels_tpu_torch.embedding.gather import gather_rows, gather_rows_reference
from recmodels_tpu_torch.embedding.optim import bag_sorted_ids
from recmodels_tpu_torch.embedding.update import (
    adam_constants, adam_scalars, sorted_adagrad_update, sorted_adagrad_update_reference, sorted_adam_update,
    sorted_adam_update_reference,
)
from recmodels_tpu_torch.nn.mlp import ProductF32, mlp_apply, mlp_init
from recmodels_tpu_torch.nn.mlp_epilogue import act_backward, act_backward_reference, bias_act, bias_act_reference
from recmodels_tpu_torch.ops.cuda import build
from recmodels_tpu_torch.ops.cuda import interactions_cuda as K
from recmodels_tpu_torch.utils import profiling

pytestmark = pytest.mark.cuda

# bf16 results summed in f32 in another order may round one bf16 step apart
# (2^-8 relative); 1% of the largest magnitude covers that with margin
BF16_REL_TOL = 1e-2
# f32 CIN layer: the same f32 sums (up to Hk * m terms) in another order
F32_REL_TOL = 1e-4
# the card's logits against the CPU's plain path: the same formulas, bf16
# rounding flips from summation order through the interaction and the MLP;
# BCE is 1-Lipschitz in each logit, so it bounds a step's loss too
LOGIT_REL_TOL = 1e-2
# the card's step against the CPU's from one state: the grads pass through
# the same bf16 rounding points, one that lands a bf16 step apart moves a
# grad by about 2^-8 of its size; 3% of each tensor's largest change (the
# repo's bf16 rule, tests/test_tpu_kernels.py) bounds it
STEP_REL_TOL = 0.03


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _gen(dev, seed=0):
    return torch.Generator(device=dev).manual_seed(seed)


@pytest.mark.parametrize("n_ids", [(1,), (3, 26), (1000, 26)])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_gather_kernel_is_exact(cuda, n_ids, out_dtype):
    g = _gen(cuda)
    table = torch.randn((5000, 17), generator=g, device=cuda)
    ids = torch.randint(0, 5000, n_ids, generator=g, device=cuda, dtype=torch.int32)
    ids.view(-1)[0] = 4999
    before = gather_rows.launches
    got = gather_rows(table, ids, out_dtype)
    torch.cuda.synchronize()
    assert gather_rows.launches == before + 1
    assert torch.equal(got, gather_rows_reference(table, ids, out_dtype))


def _gather_checked(table, ids, out_dtype):
    """One launch, bit for bit the plain version, and a second call the same."""
    before = gather_rows.launches
    got = gather_rows(table, ids, out_dtype)
    torch.cuda.synchronize()
    assert gather_rows.launches == before + 1
    assert got.shape == (*ids.shape, table.shape[1]) and got.dtype == out_dtype
    assert torch.equal(got, gather_rows_reference(table, ids, out_dtype))
    assert torch.equal(gather_rows(table, ids, out_dtype), got)


# a warp's tile is 32 ids, its output whole 16-byte chunks (d1 = 1 takes
# a thread an id): n runs across those edges, to the flagship's 425,984
# ids and past it to a ragged last tile
@pytest.mark.parametrize("n", [0, 1, 7, 8, 9, 26, 26_000, 425_984, 425_987])
@pytest.mark.parametrize("d1", [1, 16, 17, 33])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_gather_kernel_at_tile_edges(cuda, n, d1, out_dtype):
    g = _gen(cuda, 19)
    rows = 200_003
    table = torch.randn((rows, d1), generator=g, device=cuda) * 3
    ids = torch.randint(0, rows, (n,), generator=g, device=cuda, dtype=torch.int32)
    if n:
        ids[-1] = rows - 1
    _gather_checked(table, ids, out_dtype)


@pytest.mark.parametrize("n", [9, 26_000, 425_987])
@pytest.mark.parametrize("d1", [1, 17])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("which", ["first", "last"])
def test_gather_kernel_one_id_throughout(cuda, n, d1, out_dtype, which):
    g = _gen(cuda, 20)
    rows = 5000
    table = torch.randn((rows, d1), generator=g, device=cuda)
    ids = torch.full((n,), 0 if which == "first" else rows - 1, dtype=torch.int32, device=cuda)
    _gather_checked(table, ids, out_dtype)


@pytest.mark.parametrize("d1", [3, 5, 20, 34, 40, 65])  # from 34: past the tiles, a thread a value
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_gather_kernel_other_row_widths(cuda, d1, out_dtype):
    g = _gen(cuda, 21)
    table = torch.randn((3000, d1), generator=g, device=cuda)
    ids = torch.randint(0, 3000, (1000, 26), generator=g, device=cuda, dtype=torch.int32)
    _gather_checked(table, ids, out_dtype)


# (b, m, d): the fanout's periods are the least run of whole examples whose
# input and output span whole 16-byte chunks (4 examples at m = 26, d = 16 in
# bf16, 2 in f32; 8 at m = 7, d = 3 in bf16), its groups up to 16 KB of periods
_FANOUT_SHAPES = [
    (1, 26, 16), (17, 26, 16), (300, 26, 16),
    (0, 26, 16),
    (3, 26, 16),       # less than a period
    (4, 26, 16),       # one bf16 period
    (5, 26, 16),       # a ragged period
    (16384, 26, 16),   # more groups than resident blocks
    (16387, 26, 16),   # and a ragged tail
    (37, 26, 32),      # bench.py --dim 32: 1,716-byte rows
    (41, 26, 1),
    (23, 7, 3),        # odd sizes: 8-example periods in bf16
    (3, 12, 1023),     # f32 rows at the 48 KB limit (the plain path)
    (3, 24, 1023),     # bf16 rows at the limit; f32 past it
    (2, 25, 1023),     # past the limit in both
]


def _fanout_takes(m, d, dtype):
    return m * (d + 1) * dtype.itemsize <= K.SPLIT_FUSED_MAX_EXAMPLE_BYTES


@pytest.mark.parametrize("b,m,d", _FANOUT_SHAPES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_split_fused_rows_kernel(cuda, b, m, d, dtype):
    full = torch.randn((b, m, d + 1), generator=_gen(cuda), device=cuda).to(dtype)
    before = K.split_fused_rows.launches
    if not _fanout_takes(m, d, dtype):
        with pytest.raises(ValueError, match="it takes examples within 49152 bytes"):
            K.split_fused_rows(full, d)
        assert K.split_fused_rows.launches == before
        return
    x_dm, ws = K.split_fused_rows(full, d)
    torch.cuda.synchronize()
    assert K.split_fused_rows.launches == before + 1
    x_ref, ws_ref = K.split_fused_rows_reference(full, d)
    assert torch.equal(x_dm, x_ref) and ws.shape == (b,)
    torch.testing.assert_close(ws, ws_ref, rtol=1e-5, atol=1e-5)  # f32 sums in another order
    x2, ws2 = K.split_fused_rows(full, d)
    assert torch.equal(x2, x_dm) and torch.equal(ws2, ws)


_CIN2_SHAPES = [
    (1, 16, 26, 128, 128),   # one served request
    (33, 16, 26, 128, 128),  # ragged: 4 full tiles of 8 examples and one example
    (20, 8, 26, 16, 32),
    (5, 3, 7, 48, 16),
    (37, 32, 26, 128, 128),  # d = 32 (bench.py --dim 32): 4 examples a tile, ragged
    (9, 1, 26, 128, 128),    # d = 1
    (11, 16, 4, 64, 16),     # m = 4
    (21, 16, 26, 256, 256),  # the widest layers
    (13, 32, 32, 256, 240),  # every limit at once, h2 not a multiple of 64
    (300, 16, 26, 128, 128),
]


@pytest.mark.parametrize("b,d,m,h1,h2", _CIN2_SHAPES)
def test_cin2_forward_kernel(cuda, b, d, m, h1, h2):
    g = _gen(cuda, 1)
    x02 = torch.randn((b * d, m), generator=g, device=cuda).to(torch.bfloat16)
    w1 = (torch.randn((m, m * h1), generator=g, device=cuda) * (2.0 / (m * m)) ** 0.5).to(torch.bfloat16)
    w2 = (torch.randn((h1, m * h2), generator=g, device=cuda) * (2.0 / (h1 * m)) ** 0.5).to(torch.bfloat16)
    before = K.cin2_forward.launches
    outs = K.cin2_forward(x02, w1, w2, d, want_x1=True, want_q=True)
    torch.cuda.synchronize()
    assert K.cin2_forward.launches == before + 1
    refs = K.cin2_forward_reference(x02, w1, w2, d, want_x1=True, want_q=True)
    for got, want in zip(outs, refs):
        assert got.shape == want.shape and got.dtype == torch.bfloat16
        err = (got.float() - want.float()).abs().max().item()
        assert err <= BF16_REL_TOL * want.float().abs().max().item()
    _, p1, p2, _ = K.cin2_forward(x02, w1, w2, d)
    assert torch.equal(p1, outs[1]) and torch.equal(p2, outs[2])


def test_cin_stack_dm_flat_f32_runs_the_layer_kernel(cuda):
    """An f32 CIN (no fused kernel) runs layer by layer through the generic
    layer kernel, forward and backward (the einsum backward: f32)."""
    g = _gen(cuda, 6)
    x = torch.randn((3, 16, 26), generator=g, device=cuda)
    w = [torch.randn((26, 26 * 16), generator=g, device=cuda) * 0.1,
         torch.randn((16, 26 * 16), generator=g, device=cuda) * 0.1]
    before = K.cin_layer_forward.launches
    xr = x.clone().requires_grad_(True)
    pools = K.cin_stack_dm_flat(xr, w)
    assert K.cin_layer_forward.launches == before + 2 and pools.shape == (3, 32)
    want = K.interactions.cin_stack_dm_flat(x, w)
    torch.testing.assert_close(pools, want, rtol=F32_REL_TOL, atol=F32_REL_TOL * want.abs().max().item())
    (gx,) = torch.autograd.grad(pools.sum(), xr)
    xp = x.clone().requires_grad_(True)
    (gp,) = torch.autograd.grad(K.interactions.cin_stack_dm_flat(xp, w).sum(), xp)
    torch.testing.assert_close(gx, gp, rtol=F32_REL_TOL, atol=F32_REL_TOL * gp.abs().max().item())


@pytest.mark.parametrize("b,m,d", _FANOUT_SHAPES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_split_fused_rows_backward_kernel(cuda, b, m, d, dtype):
    g = _gen(cuda, 2)
    g_dm = torch.randn((b, d, m), generator=g, device=cuda).to(dtype)
    g_ws = torch.randn((b,), generator=g, device=cuda)
    before = K.split_fused_rows_backward.launches
    if not _fanout_takes(m, d, dtype):
        with pytest.raises(ValueError, match="it takes examples within 49152 bytes"):
            K.split_fused_rows_backward(g_dm, g_ws)
        assert K.split_fused_rows_backward.launches == before
        return
    got = K.split_fused_rows_backward(g_dm, g_ws)
    torch.cuda.synchronize()
    assert K.split_fused_rows_backward.launches == before + 1
    assert torch.equal(got, K.split_fused_rows_backward_reference(g_dm, g_ws))
    assert torch.equal(K.split_fused_rows_backward(g_dm, g_ws), got)


def _stream(cuda, rows, dim, n, hot, grad_dtype, seed=3, layout=None):
    """Sorted ids with a hot id taking ``hot`` of the stream and, in streams
    of 5 or more, sentinels (ids >= rows) at the tail; the table, acc and
    grads. ``layout`` ("run", start, length): one id holds exactly the
    positions [start, start + length), smaller ids before it and larger
    after; ("sentinels",): every id is a sentinel."""
    g = _gen(cuda, seed)
    ids = torch.randint(0, rows, (n,), generator=g, device=cuda, dtype=torch.int32)
    ids[torch.rand((n,), generator=g, device=cuda) < hot] = rows // 3
    ids = torch.sort(ids).values
    if layout is not None and layout[0] == "run":
        _, start, length = layout
        mid, end = rows // 2, start + length
        ids[:start] = torch.sort(ids[:start] % mid).values
        ids[start:end] = mid
        ids[end:] = torch.sort(mid + 1 + ids[end:] % (rows - mid - 1)).values
    if layout == ("sentinels",):
        ids += rows
    if n >= 5:
        ids[-3:] = torch.tensor([rows, rows, rows + 7], dtype=torch.int32, device=cuda)
    shape = (rows,) if dim == 1 else (rows, dim)
    table = torch.randn(shape, generator=g, device=cuda)
    acc = torch.rand(shape, generator=g, device=cuda) + 0.1
    grads = torch.randn((n, *shape[1:]), generator=g, device=cuda).to(grad_dtype)
    return table, acc, ids, grads


def _off16(t, nbytes):
    """A copy of ``t`` whose data starts ``nbytes`` past a 16-byte boundary,
    a slice of a larger buffer as a caller's view would be."""
    es = t.element_size()
    buf = torch.empty(t.numel() + 32 // es, dtype=t.dtype, device=t.device)
    start = (-buf.data_ptr() % 16 + nbytes) // es
    view = buf[start:start + t.numel()].view(t.shape)
    view.copy_(t)
    assert view.data_ptr() % 16 == nbytes
    return view


def _placed(layout, grads, *state):
    """``grads`` and the state arrays where ``layout`` ("views", grad
    elements, state bytes) puts them: the grads that many elements (2 bytes
    each in bf16) and the state that many bytes off 16; else aligned copies."""
    g_elems, s_bytes = layout[1:] if layout is not None and layout[0] == "views" else (0, 0)
    return (_off16(grads, g_elems * grads.element_size()), *(_off16(t, s_bytes) for t in state))


# Streams for the update kernels: (rows, dim, n, hot, layout). The kernels
# take 32 stream positions a warp at a time (csrc/sorted_update_common.cuh):
# runs from a tile's last lane (position 31) cross one or two tile edges, a
# run of 2,000 spans about 60 tiles, and past 8 KB of grads a tile (d = 65
# in f32, d = 300) the grads are read from device memory.
_UPDATE_CASES = [
    (5000, 17, 5, 0.0, None),
    (5000, 17, 3001, 0.0, None),
    (5000, 17, 3001, 0.6, None),   # a run of ~1,800 duplicates
    (2000, 1, 4000, 0.3, None),    # a dim-1 table
    (300, 5, 20000, 0.9, None),    # nearly every position a duplicate
    (5000, 16, 3001, 0.0, None),
    (5000, 32, 3001, 0.3, None),
    (3000, 64, 3001, 0.3, None),
    (700, 65, 2000, 0.3, None),
    (500, 300, 1000, 0.3, None),
    *[(5000, d, 4000, 0.0, ("run", 31, length)) for d in (1, 16, 17) for length in (33, 64, 65)],
    (5000, 17, 4000, 0.0, ("run", 95, 2000)),
    (5000, 16, 4000, 0.0, ("run", 95, 2000)),
    (5000, 17, 0, 0.0, None),
    (5000, 17, 1, 0.0, None),
    (5000, 17, 300, 0.0, ("sentinels",)),
    *[(5000, d, 3001, 0.3, ("views", g_elems, s_bytes))
      for d, g_elems, s_bytes in ((16, 1, 4), (17, 1, 4), (1, 1, 4), (16, 1, 0), (16, 0, 4))],
    # DLRM-DCNv2's 128-wide rows: a tile's group of 8 warps takes 32 float4
    # columns a row
    (20000, 128, 20001, 0.3, None),
    (5000, 128, 4000, 0.0, ("run", 95, 2000)),
]


@pytest.mark.parametrize("rows,dim,n,hot,layout", _UPDATE_CASES)
@pytest.mark.parametrize("grad_dtype", [torch.bfloat16, torch.float32])
def test_adagrad_update_kernel_is_bit_exact(cuda, rows, dim, n, hot, layout, grad_dtype):
    """Against the plain version on the CPU, which sums each run in stream
    order as the kernel does; every operation rounds the same way, so the
    two agree bit for bit. Rows outside the stream keep their bits; a second
    call from the same state gives the same bits."""
    table, acc, ids, grads = _stream(cuda, rows, dim, n, hot, grad_dtype, layout=layout)
    grads, table, acc = _placed(layout, grads, table, acc)
    lr = torch.tensor(0.05, device=cuda)  # read from device memory, as a captured step does
    t_cpu, a_cpu = table.cpu(), acc.cpu()
    sorted_adagrad_update_reference(t_cpu, a_cpu, ids.cpu(), grads.cpu(), lr.cpu(), 1e-8)
    t0, a0 = table.clone(), acc.clone()
    _, t1, a1 = _placed(layout, grads, table, acc)
    before = sorted_adagrad_update.launches
    sorted_adagrad_update(table, acc, ids, grads, lr, 1e-8)
    torch.cuda.synchronize()
    assert sorted_adagrad_update.launches == before + 1
    assert torch.equal(table.cpu(), t_cpu) and torch.equal(acc.cpu(), a_cpu)
    touched = torch.zeros(rows, dtype=torch.bool, device=cuda)
    touched[ids[(ids >= 0) & (ids < rows)].long()] = True
    assert torch.equal(table[~touched], t0[~touched])
    sorted_adagrad_update(t1, a1, ids, grads, lr, 1e-8)
    assert torch.equal(t1, table) and torch.equal(a1, acc)


@pytest.mark.parametrize("b,d,m,h1,h2", _CIN2_SHAPES + [(1100, 16, 26, 128, 128)])  # several slices
def test_cin2_backward_kernel(cuda, b, d, m, h1, h2):
    g = _gen(cuda, 4)
    x02 = torch.randn((b * d, m), generator=g, device=cuda).to(torch.bfloat16)
    w1 = (torch.randn((m, m * h1), generator=g, device=cuda) * (2.0 / (m * m)) ** 0.5).to(torch.bfloat16)
    w2 = (torch.randn((h1, m * h2), generator=g, device=cuda) * (2.0 / (h1 * m)) ** 0.5).to(torch.bfloat16)
    x1, _, _, q = K.cin2_forward(x02, w1, w2, d, want_x1=True, want_q=True)
    g1p = torch.randn((b, h1), generator=g, device=cuda).to(torch.bfloat16)
    g2p = torch.randn((b, h2), generator=g, device=cuda).to(torch.bfloat16)
    before = K.cin2_backward.launches
    outs = K.cin2_backward(x02, x1, w1, w2, q, g1p, g2p, d)
    torch.cuda.synchronize()
    assert K.cin2_backward.launches == before + 1
    refs = K.cin2_backward_reference(x02, x1, w1, w2, q, g1p, g2p, d)
    for got, want in zip(outs, refs):
        assert got.shape == want.shape and got.dtype == torch.bfloat16
        err = (got.float() - want.float()).abs().max().item()
        assert err <= BF16_REL_TOL * want.float().abs().max().item()
    again = K.cin2_backward(x02, x1, w1, w2, q, g1p, g2p, d)
    assert all(torch.equal(x, y) for x, y in zip(outs, again))  # no atomics: runs repeat


def test_product_function_on_the_card(cuda):
    """The bf16 product's forward and backward through cuBLAS against the
    widened f32 products (the same sums in another order)."""
    g = _gen(cuda, 5)
    a = torch.randn((300, 70), generator=g, device=cuda).to(torch.bfloat16).requires_grad_(True)
    w = torch.randn((70, 40), generator=g, device=cuda).to(torch.bfloat16).requires_grad_(True)
    cot = torch.randn((300, 40), generator=g, device=cuda).to(torch.bfloat16).float()
    out = ProductF32.apply(a, w)
    ga, gw = torch.autograd.grad((out * cot).sum(), (a, w))
    ref = a.detach().float() @ w.detach().float()
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(ga.float(), (cot @ w.detach().float().t()).to(torch.bfloat16).float(),
                               rtol=2 ** -7, atol=1e-5)
    torch.testing.assert_close(gw.float(), (a.detach().float().t() @ cot).to(torch.bfloat16).float(),
                               rtol=2 ** -7, atol=1e-5)


# the bias grad: the same bf16 values summed in f32 in another order, each
# partial sum within a few f32 ulps of the column's |g_z| sum
MLP_BIAS_TOL = 1e-5
# the widths the MLPs take (the logit's 1, DLRM's, DeepFM's 400) and one
# that is no multiple of 8 (the scalar path)
_MLP_WIDTHS = [1, 128, 256, 400, 512, 1024, 100]


def _bias_grad_close(got, want, gz):
    assert got.dtype == torch.float32 and got.shape == want.shape
    bound = MLP_BIAS_TOL * gz.float().abs().sum(dim=0)
    assert torch.all((got - want).abs() <= bound), (got - want).abs().max().item()


@pytest.mark.parametrize("b", [16384, 1000])
@pytest.mark.parametrize("n", _MLP_WIDTHS)
@pytest.mark.parametrize("relu", [True, False])
def test_mlp_epilogue_kernels_match_their_plain_versions(cuda, b, n, relu):
    """The forward kernel bit for bit its plain version (the chain z + b,
    relu, cast); the backward's g_z bit for bit for an f32 cotangent (the
    layer above's input grad) and a bf16 one, its bias grad within
    MLP_BIAS_TOL of the column's |g_z| sum, and bit for bit a second call
    (no atomics)."""
    g = _gen(cuda, n + b)
    z = torch.randn((b, n), generator=g, device=cuda) * 2
    bias = torch.randn((n,), generator=g, device=cuda)
    before = bias_act.launches
    h = bias_act(z, bias, relu)
    torch.cuda.synchronize()
    assert bias_act.launches == before + 1
    assert h.dtype == torch.bfloat16 and torch.equal(h, bias_act_reference(z, bias, relu))
    mask = h if relu else None
    for g_dtype in (torch.float32, torch.bfloat16):
        cot = torch.randn((b, n), generator=g, device=cuda).to(g_dtype)
        gz, gb = act_backward(cot, mask)
        want_z, want_b = act_backward_reference(cot, mask)
        assert gz.dtype == torch.bfloat16 and torch.equal(gz, want_z)
        _bias_grad_close(gb, want_b, want_z)
        again = act_backward(cot, mask)
        assert torch.equal(again[0], gz) and torch.equal(again[1], gb)


def test_mlp_epilogue_kernels_on_tensors_off_16_bytes(cuda):
    """Tensors that start off a 16-byte boundary take the one-element path,
    with the same bits."""
    g = _gen(cuda, 3)
    b, n = 1000, 512

    def off(t):
        flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=cuda)
        flat[1:] = t.reshape(-1)
        return flat[1:].view(t.shape)

    z, bias = off(torch.randn((b, n), generator=g, device=cuda)), off(torch.randn((n,), generator=g, device=cuda))
    h = bias_act(z, bias, True)
    assert torch.equal(h, bias_act_reference(z, bias, True))
    cot, hm = off(torch.randn((b, n), generator=g, device=cuda)), off(h)
    gz, gb = act_backward(cot, hm)
    want_z, want_b = act_backward_reference(cot, hm)
    assert torch.equal(gz, want_z)
    _bias_grad_close(gb, want_b, want_z)


@pytest.mark.parametrize("n", [1, 100, 1024])
def test_mlp_epilogue_kernels_propagate_nan_as_torch(cuda, n):
    """A NaN in z stays NaN through the forward, as through torch.relu; a
    NaN output passes its grad and a NaN cotangent stays NaN, as through
    threshold_backward; elsewhere the bits of autograd's chain."""
    g = _gen(cuda, 17)
    b = 300
    z = torch.randn((b, n), generator=g, device=cuda)
    z[5, n // 2] = float("nan")
    z[9, 0] = float("nan")
    z[11, n - 1] = 100.0  # a positive output whose cotangent is NaN
    bias = torch.randn((n,), generator=g, device=cuda)
    h = bias_act(z, bias, True)
    zz = (z + bias).requires_grad_(True)
    out = torch.relu(zz)
    torch.testing.assert_close(h, out.detach().to(torch.bfloat16), rtol=0, atol=0, equal_nan=True)
    assert torch.isnan(h[5, n // 2]) and torch.isnan(h[9, 0])
    cot = torch.randn((b, n), generator=g, device=cuda)
    cot[11, n - 1] = float("nan")
    (want,) = torch.autograd.grad(out, zz, cot.to(torch.bfloat16).float())
    gz, gb = act_backward(cot, h)
    torch.testing.assert_close(gz.float(), want, rtol=0, atol=0, equal_nan=True)
    assert gz[5, n // 2] == cot[5, n // 2].to(torch.bfloat16) and torch.isnan(gz[11, n - 1])
    assert torch.isnan(gb[n - 1])


def _old_mlp_chain(layers, x, final_linear):
    """The bf16 MLP before ``MlpStack``: autograd through ``ProductF32``,
    PyTorch's f32 bias add, relu and cast."""
    h = x.to(torch.bfloat16)
    n = len(layers)
    for i, layer in enumerate(layers):
        h = ProductF32.apply(h, layer["w"].to(torch.bfloat16)) + layer["b"]
        if not (final_linear and i == n - 1):
            h = torch.relu(h)
        h = h.to(torch.bfloat16)
    return h.float()


def _mlp_and_grads(fn, layers, x, x_grad, cot):
    params = [{k: v.clone().requires_grad_(True) for k, v in layer.items()} for layer in layers]
    x = x.clone().requires_grad_(x_grad)
    out = fn(params, x)
    leaves = [t for p in params for t in (p["w"], p["b"])] + ([x] if x_grad else [])
    return out, torch.autograd.grad((out * cot).sum(), leaves)


# (in, hidden, out_dim, final_linear, x bf16 needing a grad): DLRM-DCNv2's
# top on the cross stack's output and its bottom on the dense features,
# DeepFM's DNN(400,400,400) on its [B, 429] input
_MLP_CASES = {
    "dlrm_top": (3456, (1024, 1024, 512, 256), 1, True, True),
    "dlrm_bottom": (13, (512, 256, 128), None, False, False),
    "deepfm": (429, (400, 400, 400), 1, True, True),
}


@pytest.mark.parametrize("case", list(_MLP_CASES))
def test_mlp_stack_on_the_card_equals_the_old_chain(cuda, case):
    """``mlp_apply`` in bf16 on the card against the chain it replaced, from
    one state at 4,096 examples: outputs, input grads and weight grads bit
    for bit (the same cuBLAS products of the same bf16 operands, the same
    roundings), each bias grad within MLP_BIAS_TOL of its column's |g_z|
    sum; and the epilogue kernels ran, once a layer each way."""
    d_in, hidden, out_dim, final_linear, x_grad = _MLP_CASES[case]
    g = _gen(cuda, 23)
    layers = mlp_init(g, d_in, hidden, out_dim=out_dim, device=cuda)
    for layer in layers:
        layer["b"] = torch.randn(layer["b"].shape, generator=g, device=cuda) * 0.1
    x = torch.randn((4096, d_in), generator=g, device=cuda)
    x = x.to(torch.bfloat16) if x_grad else x
    n_out = out_dim or hidden[-1]
    cot = torch.randn((4096, n_out), generator=g, device=cuda)
    before = (bias_act.launches, act_backward.launches)
    got_out, got = _mlp_and_grads(lambda p, h: mlp_apply(p, h, final_linear, torch.bfloat16), layers, x, x_grad, cot)
    torch.cuda.synchronize()
    assert (bias_act.launches - before[0], act_backward.launches - before[1]) == (len(layers), len(layers))
    want_out, want = _mlp_and_grads(lambda p, h: _old_mlp_chain(p, h, final_linear), layers, x, x_grad, cot)
    assert torch.equal(got_out, want_out)
    for j, (a, w) in enumerate(zip(got, want)):
        assert a.dtype == w.dtype and a.shape == w.shape
        if j < 2 * len(layers) and j % 2 == 1:
            continue
        assert torch.equal(a, w), j
    # the bias grads against each layer's g_z from the old chain
    params = [{k: v.clone().requires_grad_(True) for k, v in layer.items()} for layer in layers]
    zs, h = [], x.to(torch.bfloat16)
    for i, p in enumerate(params):
        z = ProductF32.apply(h, p["w"].to(torch.bfloat16)) + p["b"]
        z.retain_grad()
        zs.append(z)
        h = (z if final_linear and i == len(params) - 1 else torch.relu(z)).to(torch.bfloat16)
    (h.float() * cot).sum().backward()
    for i, z in enumerate(zs):
        _bias_grad_close(got[2 * i + 1], want[2 * i + 1], z.grad)


def test_mlp_stack_captured_equals_eager(cuda):
    """A CUDA graph of DLRM-DCNv2's top MLP forward and backward replays to
    the eager call's bits, bias grads too (no atomics). The leaves are made
    inside the captured call, as ``Engine`` makes its live parameters."""
    d_in, hidden, out_dim, final_linear, _ = _MLP_CASES["dlrm_top"]
    g = _gen(cuda, 29)
    layers = mlp_init(g, d_in, hidden, out_dim=out_dim, device=cuda)
    x0 = torch.randn((2048, d_in), generator=g, device=cuda).to(torch.bfloat16)
    cot = torch.randn((2048, 1), generator=g, device=cuda)

    def run():
        params = [{k: v.detach().requires_grad_(True) for k, v in layer.items()} for layer in layers]
        x = x0.detach().requires_grad_(True)
        out = mlp_apply(params, x, final_linear, torch.bfloat16)
        leaves = [t for p in params for t in (p["w"], p["b"])] + [x]
        return (out.detach(), *torch.autograd.grad((out * cot).sum(), leaves))

    eager = [t.clone() for t in run()]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static = run()
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(static, eager))


@pytest.mark.parametrize("rows,dim,n,hot,layout", _UPDATE_CASES)
@pytest.mark.parametrize("grad_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("step", [0, 5])
def test_adam_update_kernel_is_bit_exact(cuda, rows, dim, n, hot, layout, grad_dtype, step):
    """Lazy Adam against the plain version on the CPU (the same f32
    constants, runs summed in stream order, every operation rounded the same
    way): bit for bit. An id whose grads sum to exactly 0 still decays its
    moments; rows outside the stream keep their bits; a second call from the
    same state gives the same bits."""
    table, acc, ids, grads = _stream(cuda, rows, dim, n, hot, grad_dtype, seed=7, layout=layout)
    m = acc - 0.6
    v = acc * 0.01
    # the first id's run: grads summing to exactly 0 (x and -x, or zeros)
    zero_run = n > 0 and ids[0] < rows
    if zero_run:
        x = grads[0].clone()
        grads[ids == ids[0]] = 0
        if n > 1 and ids[1] == ids[0]:
            grads[0], grads[1] = x, -x
    grads, table, m, v = _placed(layout, grads, table, m, v)
    # [lr, bc1, bc2] computed on the card from a step tensor
    scalars = adam_scalars(torch.tensor(1e-2, device=cuda), torch.tensor(step, dtype=torch.int32, device=cuda),
                           0.9, 0.999)
    hyper = dict(scalars=scalars, b1=0.9, b2=0.999, eps=1e-8)
    cpu = [t.cpu() for t in (table, m, v)]
    sorted_adam_update_reference(*cpu, ids.cpu(), grads.cpu(), **{**hyper, "scalars": scalars.cpu()})
    t0, m0 = table.clone(), m.clone()
    _, *again = _placed(layout, grads, table, m, v)
    before = sorted_adam_update.launches
    sorted_adam_update(table, m, v, ids, grads, **hyper)
    torch.cuda.synchronize()
    assert sorted_adam_update.launches == before + 1
    for got, want in zip((table, m, v), cpu):
        assert torch.equal(got.cpu(), want)
    if zero_run:
        first = ids[0].long()
        assert not torch.equal(m[first], m0[first])  # decayed: 0.9 * m
    touched = torch.zeros(rows, dtype=torch.bool, device=cuda)
    touched[ids[(ids >= 0) & (ids < rows)].long()] = True
    assert torch.equal(table[~touched], t0[~touched]) and torch.equal(m[~touched], m0[~touched])
    sorted_adam_update(*again, ids, grads, **hyper)
    assert all(torch.equal(a, b) for a, b in zip(again, (table, m, v)))


def _layer_inputs(cuda, rows, hk, m, hn, dtype, seed):
    g = _gen(cuda, seed)
    xk2 = torch.randn((rows, hk), generator=g, device=cuda).to(dtype)
    x02 = torch.randn((rows, m), generator=g, device=cuda).to(dtype)
    w2 = (torch.randn((hk, m * hn), generator=g, device=cuda) * (2.0 / (hk * m)) ** 0.5).to(dtype)
    return xk2, x02, w2


@pytest.mark.parametrize("rows,hk,m,hn", [
    (1000, 26, 26, 128),   # layer 1 at the training widths, ragged rows
    (700, 128, 26, 128),   # layers 2 and 3
    (77, 37, 5, 20),       # nothing aligned
    (300, 200, 3, 130),    # two k-chunks and two column blocks
    # the f32 kernel's tile edges: 128-row blocks, 128-wide chunks of Hk,
    # 128-column blocks, K tiles of 16 that span fields
    (129, 129, 3, 130),    # one row past a block, one h past a chunk, unaligned Hn
    (257, 7, 39, 1),       # a tile spans three fields; one column
    (257, 129, 1, 128),    # one field
    (129, 7, 39, 130),
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cin_layer_forward_kernel(cuda, rows, hk, m, hn, dtype):
    _check_cin_layer_forward(*_layer_inputs(cuda, rows, hk, m, hn, dtype, 8))


def _check_cin_layer_forward(xk2, x02, w2):
    rows, hn, dtype = xk2.shape[0], w2.shape[1] // x02.shape[1], xk2.dtype
    before = K.cin_layer_forward.launches
    got = K.cin_layer_forward(xk2, x02, w2)
    torch.cuda.synchronize()
    assert K.cin_layer_forward.launches == before + 1
    want = K.cin_layer_forward_reference(xk2, x02, w2)
    assert got.shape == (rows, hn) and got.dtype == dtype
    tol = BF16_REL_TOL if dtype == torch.bfloat16 else F32_REL_TOL
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol * want.float().abs().max().item()
    assert torch.equal(got, K.cin_layer_forward(xk2, x02, w2))  # no atomics: runs repeat


@pytest.mark.parametrize("rows,hk,m,hn", [
    (4096, 26, 26, 128),   # layer 1: 52-byte rows of xk, padded first; 32-row w2 boxes
    (300, 100, 26, 100),   # CIN(100,100): w2's 200-byte field stride and xk padded first
    (260, 16, 26, 8),      # Hk below one 32-row box, Hn below one 64-wide box
    (1000, 40, 3, 20),     # one K tile of 64 h, three of its four K slices past Hk
    (500, 256, 6, 128),    # four K tiles held, a ring of 6
    (300, 384, 5, 128),    # six K tiles streamed with xk's through a ring of 7
    (300, 512, 5, 128),    # eight K tiles through a ring of 7: two windows a field
    (400, 128, 7, 384),    # three n blocks
    (700, 192, 4, 130),    # three K tiles; the last n block two columns wide
    (500, 128, 1, 128),    # one field
    (300, 64, 300, 64),    # fields in the hundreds
    (50, 128, 26, 128),    # fewer rows than one 128-row tile
    (16384, 128, 26, 128), # the training step's layer 2 at 16,384 rows
])
def test_cin_layer_forward_bf16_kernel_edges(cuda, rows, hk, m, hn):
    """The bf16 kernel (wgmma, w2 by TMA) at the edges of its tiles, ring
    and windows, and on the inputs it copies before reading them."""
    _check_cin_layer_forward(*_layer_inputs(cuda, rows, hk, m, hn, torch.bfloat16, 15))


def test_cin_layer_forward_bf16_kernel_on_views_off_16_bytes(cuda):
    """xk, x0 and w2 whose data starts 2 bytes past a 16-byte boundary: TMA
    cannot read xk and w2 as they lie, so the kernel copies them first."""
    xk2, x02, w2 = _layer_inputs(cuda, 300, 128, 5, 128, torch.bfloat16, 16)

    def off(t):
        flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        view = flat[1:].view(t.shape)
        view.copy_(t)
        return view

    _check_cin_layer_forward(off(xk2), off(x02), off(w2))


def test_cin_layer_forward_bf16_kernel_on_no_rows(cuda):
    xk2, x02, w2 = _layer_inputs(cuda, 0, 128, 26, 128, torch.bfloat16, 17)
    before = K.cin_layer_forward.launches
    got = K.cin_layer_forward(xk2, x02, w2)
    torch.cuda.synchronize()
    assert K.cin_layer_forward.launches == before + 1 and got.shape == (0, 128)


@pytest.mark.parametrize("rows,hk,m,hn", [
    (512, 128, 26, 128),    # one 512-row tile of the JAX kernel
    (5000, 128, 4, 128),    # ragged rows, two gw slices
    (300, 40, 7, 24),       # nothing aligned
    (600, 136, 5, 200),     # two h blocks and two k-chunks
    (100, 128, 26, 128),    # fewer rows than one 128-row tile
    (3000, 128, 26, 128),   # 47 K tiles over 10 gw slices, a ragged last tile
    (1000, 256, 6, 256),    # two h blocks of 128, four K tiles of 64
    (700, 128, 1, 128),     # one field: the second warpgroup of the gw pair idles
    (300, 128, 3, 320),     # Hn past 256: g streams through the ring with w2
    (512, 128, 26, 384),    # 6 K tiles through a ring of 5: two windows a field
    (512, 128, 26, 512),    # 8 K tiles through a ring of 5
    (300, 128, 100, 320),   # 5 K tiles through a ring of 4
    (333, 37, 3, 21),       # row pitches off 16 bytes: padded copies first
    (256, 128, 128, 128),   # the most fields takes_backward_kernel admits
    (130, 64, 195, 256),    # the most fields at Hn = 256: 4 g-held K tiles, a ring of 2
    (130, 64, 227, 192),    # the most at Hn = 192: 3 K tiles, a ring of 2
    (130, 64, 259, 384),    # the most past Hn = 256: 6 streamed K tiles, a ring of 2
    (16384, 128, 26, 128),  # the training step's layer at 16,384 rows
])
def test_cin_layer_backward_kernel(cuda, rows, hk, m, hn):
    xk2, x02, w2 = _layer_inputs(cuda, rows, hk, m, hn, torch.bfloat16, 9)
    gy = torch.randn((rows, hn), generator=_gen(cuda, 10), device=cuda).to(torch.bfloat16)
    _check_cin_layer_backward(xk2, x02, w2, gy)


def _check_cin_layer_backward(xk2, x02, w2, gy):
    before = K.cin_layer_backward.launches
    outs = K.cin_layer_backward(xk2, x02, w2, gy)
    torch.cuda.synchronize()
    assert K.cin_layer_backward.launches == before + 1
    refs = K.cin_layer_backward_reference(xk2, x02, w2, gy)
    for got, want in zip(outs, refs):
        assert got.shape == want.shape and got.dtype == torch.bfloat16
        err = (got.float() - want.float()).abs().max().item()
        assert err <= BF16_REL_TOL * want.float().abs().max().item()
    again = K.cin_layer_backward(xk2, x02, w2, gy)
    assert all(torch.equal(x, y) for x, y in zip(outs, again))  # no atomics: runs repeat


def test_cin_layer_backward_kernel_on_views_off_16_bytes(cuda):
    """Inputs whose data starts 2 bytes past a 16-byte boundary: TMA cannot
    read them as they lie, so the kernel copies them first."""
    rows, hk, m, hn = 300, 128, 5, 128
    xk2, x02, w2 = _layer_inputs(cuda, rows, hk, m, hn, torch.bfloat16, 11)
    gy = torch.randn((rows, hn), generator=_gen(cuda, 12), device=cuda).to(torch.bfloat16)

    def off(t):
        flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        view = flat[1:].view(t.shape)
        view.copy_(t)
        return view

    _check_cin_layer_backward(off(xk2), x02, off(w2), off(gy))


def test_cin_layer_backward_kernel_on_no_rows(cuda):
    xk2, x02, w2 = _layer_inputs(cuda, 0, 128, 26, 128, torch.bfloat16, 13)
    gy = torch.empty((0, 128), dtype=torch.bfloat16, device=cuda)
    gxk, gx0, gw = K.cin_layer_backward(xk2, x02, w2, gy)
    torch.cuda.synchronize()
    assert gxk.shape == (0, 128) and gx0.shape == (0, 26)
    assert gw.shape == w2.shape and not gw.any()


@pytest.mark.parametrize("m,hn", [(196, 256), (228, 192), (260, 384)])
def test_cin_layer_backward_kernel_refuses_fields_past_its_limit(cuda, m, hn):
    xk2, x02, w2 = _layer_inputs(cuda, 130, 64, m, hn, torch.bfloat16, 14)
    gy = torch.zeros((130, hn), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(NotImplementedError, match="it takes m up to 291"):
        K.cin_layer_backward(xk2, x02, w2, gy)


@pytest.mark.parametrize("shape", [
    (16384, 26, 16), (3, 5, 7), (1, 1, 1),
    (1000, 26, 16),     # a ragged last block
    (5, 3, 3),          # a block's range not a multiple of 16 bytes
    (16384, 16, 26),    # the transpose back (the backward's cotangent)
    (3, 256, 64),       # the largest item in f32: 64 KB of shared memory
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_transpose_minor2_kernel_is_exact(cuda, shape, dtype):
    x = torch.randn(shape, generator=_gen(cuda, 11), device=cuda).to(dtype)
    before = K.transpose_minor2.launches
    got = K.transpose_minor2(x)
    torch.cuda.synchronize()
    assert K.transpose_minor2.launches == before + 1
    assert torch.equal(got, K.transpose_minor2_reference(x))


def test_transpose_minor2_kernel_on_an_offset_view(cuda):
    """Items read from 2 bytes past a 16-byte boundary take the scalar path."""
    flat = torch.randn((1 + 64 * 26 * 16,), generator=_gen(cuda, 11), device=cuda).to(torch.bfloat16)
    x = flat[1:].view(64, 26, 16)
    assert x.data_ptr() % 16 == 2
    assert torch.equal(K.transpose_minor2(x), K.transpose_minor2_reference(x))


def test_transpose_minor2_kernel_refuses_an_item_past_its_limit(cuda):
    x = torch.zeros((2, 257, 64), device=cuda)  # 65,792 bytes an item
    before = K.transpose_minor2.launches
    with pytest.raises(ValueError, match="it takes items within 65536 bytes"):
        K.transpose_minor2(x)
    assert K.transpose_minor2.launches == before


@pytest.mark.parametrize("hk,kernel", [(26, False), (128, True)])
def test_cin_layer_function_on_the_card(cuda, hk, kernel):
    """``CinLayer2d`` forward and backward against autograd through the
    plain forward on the card: the aligned bf16 layer takes the backward
    kernel, layer 1 (Hk = m = 26) the einsums."""
    rows, m, hn = 1024, 26, 128
    xk2, x02, w2 = _layer_inputs(cuda, rows, hk, m, hn, torch.bfloat16, 12)
    cot = torch.randn((rows, hn), generator=_gen(cuda, 13), device=cuda).to(torch.bfloat16)
    grads = []
    for fn in (K.CinLayer2d.apply, K.cin_layer_forward_reference):
        ins = [t.clone().requires_grad_(True) for t in (xk2, x02, w2)]
        before = K.cin_layer_backward.launches
        out = fn(*ins)
        grads.append(torch.autograd.grad((out.float() * cot.float()).sum(), ins))
        if fn is K.CinLayer2d.apply:
            assert K.cin_layer_backward.launches == before + int(kernel)
    for got, want in zip(*grads):
        err = (got.float() - want.float()).abs().max().item()
        assert err <= 0.03 * want.float().abs().max().item()  # the repo's bf16 rule


def _fm_scale(emb: torch.Tensor) -> torch.Tensor:
    """Per example ||sum_f e_f||^2 + sum_f ||e_f||^2: the FM term is their
    halved difference, which cancels, so errors are held to this sum."""
    e = emb.double()
    return (e.sum(1) ** 2).sum(1) + (e ** 2).sum((1, 2))


@pytest.mark.parametrize("b,f,d,view", [
    (1, 26, 16, True),       # the engine's stride-17 view, one example
    (97, 26, 16, True),      # ragged B on the view
    (300, 26, 16, False),    # packed; half a warp an example
    (33, 5, 40, False),      # D > 32: a lane takes two columns
    (50, 3, 5, True),        # groups of 8 lanes
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_fm_pairwise_kernel(cuda, b, f, d, view, dtype):
    """Against the plain version on the card, per example to a share of
    ||sum e||^2 + sum ||e||^2 (the term cancels): the same rounding points,
    sums in another order; bf16 1% (a rounding one step apart moves s_d^2 by
    2^-8 of itself), f32 1e-5."""
    full = torch.randn((b, f, d + 1), generator=_gen(cuda, 14), device=cuda).to(dtype)
    emb = full[..., :d] if view else full[..., :d].contiguous()
    assert emb.is_contiguous() != view
    before = K.fm_pairwise_forward.launches
    got = K.fm_pairwise_forward(emb)
    torch.cuda.synchronize()
    assert K.fm_pairwise_forward.launches == before + 1
    want = K.fm_pairwise_forward_reference(emb.contiguous())
    assert got.shape == (b,) and got.dtype == dtype
    tol = (BF16_REL_TOL if dtype == torch.bfloat16 else 1e-5) * _fm_scale(emb)
    assert torch.all((got.double() - want.double()).abs() <= tol)


def test_fm_pairwise_kernel_refuses_a_view_without_unit_stride(cuda):
    x = torch.randn((4, 16, 26), device=cuda).transpose(1, 2)  # [4, 26, 16], D stride 26
    with pytest.raises(ValueError, match="unit stride along D"):
        K.fm_pairwise_forward(x)


# the staged rows go in periods of 8 bf16 or 4 f32 rows at d = 429 and
# groups of two periods, fewer when the batch is small
@pytest.mark.parametrize("b,d,n_layers", [
    (1, 429, 3),      # DCN's width, odd: bf16 rows 858 bytes apart
    (7, 429, 3),      # less than a bf16 period
    (8, 429, 3),      # one bf16 period
    (9, 429, 3),
    (97, 429, 3),     # ragged B
    (16384, 429, 3),  # DCN's batch: more groups than resident blocks
    (16387, 429, 3),  # and a ragged tail
    (40, 845, 3),     # --dim 32
    (300, 5, 2),
    (33, 1024, 6),    # the largest d of the register path; in f32 w and b fill the 48 KB exactly
    (33, 1024, 12),   # in bf16 w and b fill the 48 KB (f32: the wide-row path)
    (20, 429, 0),     # no layers: x0
    (61, 1053, 3),    # bench.py --model dcn --dim 40: the wide-row path
    (40, 1677, 3),    # --dim 64
    (50, 429, 15),    # f32: w and b past 48 KB, the wide-row path
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_dcn_cross_kernel(cuda, b, d, n_layers, dtype):
    """Against the plain version on the card, element by element to a share
    of ``dcn_cross_stack_scale``: the same rounding points and t summed in
    another order; bf16 2^-5 (a t one step apart moves x0 * t by 2^-8 of t
    and the next t by that times x0 . w), f32 1e-5. In bf16 also bit for bit
    the plain version summed in the kernel's order."""
    g = _gen(cuda, 15)
    x0 = torch.randn((b, d), generator=g, device=cuda).to(dtype)
    w = (torch.randn((n_layers, d), generator=g, device=cuda) / d ** 0.5).to(dtype)
    bias = (torch.randn((n_layers, d), generator=g, device=cuda) * 0.1).to(dtype)
    before = K.dcn_cross_stack_forward.launches
    got = K.dcn_cross_stack_forward(x0, w, bias)
    torch.cuda.synchronize()
    assert K.dcn_cross_stack_forward.launches == before + 1
    want = K.dcn_cross_stack_forward_reference(x0, w, bias)
    assert got.shape == (b, d) and got.dtype == dtype
    if n_layers == 0:
        assert torch.equal(got, x0)
        return
    rel = 2.0 ** -5 if dtype == torch.bfloat16 else 1e-5
    assert torch.all((got.double() - want.double()).abs() <= rel * K.dcn_cross_stack_scale(x0, w, bias))
    if dtype == torch.bfloat16:
        assert torch.equal(got, K.dcn_cross_stack_in_kernel_order(x0, w, bias))
    assert torch.equal(got, K.dcn_cross_stack_forward(x0, w, bias))  # no atomics: runs repeat


@pytest.mark.parametrize("b,d,n_layers", [
    (9, 429, 3), (97, 429, 3), (16387, 429, 3),
    (33, 1024, 12),  # in bf16 w and b fill the 48 KB (f32: the wide-row path)
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_dcn_cross_kernel_on_a_view_off_16_bytes(cuda, b, d, n_layers, dtype):
    """x0 whose base is off 16 bytes takes the unaligned route (a warp a
    row in device memory): the same bits as the staged rows of an aligned
    copy, in bf16 those of the plain version in the kernel's order."""
    g = _gen(cuda, 22)
    flat = torch.randn((b * d + 8,), generator=g, device=cuda).to(dtype)
    x0 = flat[3:3 + b * d].view(b, d)
    assert x0.data_ptr() % 16
    w = (torch.randn((n_layers, d), generator=g, device=cuda) / d ** 0.5).to(dtype)
    bias = (torch.randn((n_layers, d), generator=g, device=cuda) * 0.1).to(dtype)
    got = K.dcn_cross_stack_forward(x0, w, bias)
    torch.cuda.synchronize()
    assert torch.equal(got, K.dcn_cross_stack_forward(x0.clone(), w, bias))
    if dtype == torch.bfloat16:
        assert torch.equal(got, K.dcn_cross_stack_in_kernel_order(x0, w, bias))
    assert torch.equal(got, K.dcn_cross_stack_forward(x0, w, bias))


def test_cin2_takes_matches_the_kernels_own_check(cuda):
    """The route's shape function and the kernels' check agree on a grid
    around every limit."""
    lib = build.library()
    for d in (1, 16, 17, 32, 33):
        for m in (1, 26, 32, 33):
            for h1 in (8, 16, 100, 128, 240, 256, 272):
                for h2 in (16, 128, 256, 272):
                    assert bool(lib.rm_cin2_takes(d, m, h1, h2)) is K.cin2_takes(d, m, h1, h2, torch.bfloat16)


def _two_layer_cin(dev, b, d, m, h1, h2, seed):
    """bf16 field matrix [b, d, m], flat weights at the model's initial
    scale and a cotangent of the pools."""
    g = _gen(dev, seed)
    x = torch.randn((b, d, m), generator=g, device=dev).to(torch.bfloat16)
    w1 = (torch.randn((m, m * h1), generator=g, device=dev) * (2.0 / (m * m)) ** 0.5).to(torch.bfloat16)
    w2 = (torch.randn((h1, m * h2), generator=g, device=dev) * (2.0 / (h1 * m)) ** 0.5).to(torch.bfloat16)
    cot = torch.randn((b, h1 + h2), generator=g, device=dev).to(torch.bfloat16)
    return x, w1, w2, cot


def _cin_route(ins, cot, d=None):
    """Pools of ``cin_stack_dm_flat`` (``d`` given: of ``Cin2.apply`` on the
    same inputs) and the grads of the field matrix and both weights."""
    ins = [t.clone().requires_grad_(True) for t in ins]
    if d is None:
        pools = K.cin_stack_dm_flat(ins[0], ins[1:])
    else:
        b, _, m = ins[0].shape
        pools = torch.cat(K.Cin2.apply(ins[0].reshape(b * d, m), ins[1], ins[2], d), 1)
    grads = torch.autograd.grad((pools.float() * cot.float()).sum(), ins)
    return [pools.detach(), *grads]


@pytest.mark.parametrize("d,hs", [(32, (128, 128)), (32, (256, 256)), (16, (200, 200)), (16, (100, 100)),
                                  (32, (100, 100))])
def test_two_layer_bf16_cin_on_the_card_matches_the_cpu(cuda, d, hs):
    """``cin_stack_dm_flat`` on the card against the same call on the CPU
    (the plain versions of the same route): every two-layer bf16 CIN of
    widths up to 256 takes the fused kernels, one launch of each, CIN(200,
    200) and CIN(100,100) at widths zero-padded to 208 and 112. Pools by 1%
    of the largest, grads by the repo's bf16 rule (3%)."""
    b, m = 40, 26
    h1, h2 = hs
    x, w1, w2, cot = _two_layer_cin(cuda, b, d, m, h1, h2, 17)
    assert K.cin2_route_widths(d, m, h1, h2, torch.bfloat16) is not None
    outs = []
    for dev in (cuda, torch.device("cpu")):
        counts = (K.cin2_forward.launches, K.cin2_backward.launches, K.cin_layer_forward.launches)
        outs.append(_cin_route([t.to(dev) for t in (x, w1, w2)], cot.to(dev)))
        torch.cuda.synchronize()
        launched = (K.cin2_forward.launches - counts[0], K.cin2_backward.launches - counts[1],
                    K.cin_layer_forward.launches - counts[2])
        if dev.type == "cuda":
            assert launched == (1, 1, 0)
    for got, want, frac in zip(outs[0], outs[1], (BF16_REL_TOL, 0.03, 0.03, 0.03)):
        assert got.dtype == torch.bfloat16 and got.shape == want.shape
        err = (got.float().cpu() - want.float()).abs().max().item()
        assert err <= frac * want.float().abs().max().item()


@pytest.mark.parametrize("hs", [(200, 200), (100, 40)])
def test_padded_cin_route_repeats_bit_for_bit(cuda, hs):
    """The padded route (pools, and the grads of x0, w1 and w2 cut back to
    their shapes) gives the same bits in two runs on the card."""
    x, w1, w2, cot = _two_layer_cin(cuda, 300, 16, 26, *hs, 23)
    runs = [_cin_route((x, w1, w2), cot) for _ in range(2)]
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(*runs))


@pytest.mark.parametrize("d", [16, 32])
def test_cin_route_at_widths_of_16_is_cin2_unpadded(cuda, d):
    """At CIN(128,128) the route inserts no pad (``cin.fused_padded`` does
    not move): its pools and grads are bit for bit those of ``Cin2.apply``
    on the weights as they are."""
    x, w1, w2, cot = _two_layer_cin(cuda, 65, d, 26, 128, 128, 29)
    padded = profiling.snapshot()["counters"].get("cin.fused_padded", 0)
    route = _cin_route((x, w1, w2), cot)
    assert profiling.snapshot()["counters"].get("cin.fused_padded", 0) == padded
    direct = _cin_route((x, w1, w2), cot, d=d)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(route, direct))


@pytest.mark.parametrize("d,n_layers,dtype", [
    (1025, 1, torch.bfloat16),   # a row past 32 values a lane
    (1000, 7, torch.float32),    # w and b past 48 KB of shared memory
])
def test_dcn_cross_kernel_takes_shapes_past_its_register_path(cuda, d, n_layers, dtype):
    """Shapes the register path cannot hold go to the wide-row path: they
    run, match the plain version within the share of the scale, in bf16
    bit for bit the plain version in the wide path's order, and repeat."""
    g = _gen(cuda, 18)
    assert not K.dcn_rows_in_registers(d, n_layers, dtype)
    x0 = torch.randn((4, d), generator=g, device=cuda).to(dtype)
    w = (torch.randn((n_layers, d), generator=g, device=cuda) / d ** 0.5).to(dtype)
    bias = (torch.randn((n_layers, d), generator=g, device=cuda) * 0.1).to(dtype)
    before = K.dcn_cross_stack_forward.launches
    got = K.dcn_cross_stack_forward(x0, w, bias)
    torch.cuda.synchronize()
    assert K.dcn_cross_stack_forward.launches == before + 1
    want = K.dcn_cross_stack_forward_reference(x0, w, bias)
    rel = 2.0 ** -5 if dtype == torch.bfloat16 else 1e-5
    assert torch.all((got.double() - want.double()).abs() <= rel * K.dcn_cross_stack_scale(x0, w, bias))
    if dtype == torch.bfloat16:
        assert torch.equal(got, K.dcn_cross_stack_in_kernel_order(x0, w, bias))
    assert torch.equal(got, K.dcn_cross_stack_forward(x0, w, bias))


def test_fm_and_dcn_functions_on_the_card(cuda):
    """``FmPairwise`` on the stride-17 view and ``DcnCrossStack`` at d = 429,
    bf16: forward kernel plus the plain backward, against autograd through
    the plain forward on the card, by the repo's bf16 rule (3% of the
    largest grad)."""
    g = _gen(cuda, 16)
    full = torch.randn((256, 26, 17), generator=g, device=cuda).to(torch.bfloat16)
    cot = torch.randn((256,), generator=g, device=cuda).to(torch.bfloat16)
    grads = []
    for fn in (K.fm_pairwise_op, K.fm_pairwise_forward_reference):
        x = full.clone().requires_grad_(True)
        before = K.fm_pairwise_forward.launches
        out = fn(x[..., :16])
        assert K.fm_pairwise_forward.launches == before + int(fn is K.fm_pairwise_op)
        grads.append(torch.autograd.grad((out.float() * cot.float()).sum(), x)[0])
    assert torch.all(grads[0][..., 16] == 0)
    err = (grads[0].float() - grads[1].float()).abs().max().item()
    assert err <= 0.03 * grads[1].float().abs().max().item()
    x0 = torch.randn((256, 429), generator=g, device=cuda).to(torch.bfloat16)
    w = (torch.randn((3, 429), generator=g, device=cuda) / 429 ** 0.5).to(torch.bfloat16)
    bias = (torch.randn((3, 429), generator=g, device=cuda) * 0.1).to(torch.bfloat16)
    cot = torch.randn((256, 429), generator=g, device=cuda).to(torch.bfloat16)
    grads = []
    for fn in (K.dcn_cross_stack_op, K.dcn_cross_stack_forward_reference):
        ins = [t.clone().requires_grad_(True) for t in (x0, w, bias)]
        before = K.dcn_cross_stack_forward.launches
        out = fn(*ins)
        assert K.dcn_cross_stack_forward.launches == before + int(fn is K.dcn_cross_stack_op)
        grads.append(torch.autograd.grad((out.float() * cot.float()).sum(), ins))
    for got, want in zip(*grads):
        err = (got.float() - want.float()).abs().max().item()
        assert err <= 0.03 * want.float().abs().max().item()


# ------------------------------------------------ captured steps and scorer
# path: (model, its TrainConfig fields beyond vocab 1000, dim 16, DNN(64, 64)
# and bench.py's dtype: bf16 but for FM and LR)
_SMALL_PATHS = {
    "slice2": ("xdeepfm", dict(cin_sizes=(32, 32))),
    "slice3": ("xdeepfm", dict(cin_sizes=(128, 128, 128))),
    "xdeepfm_f32": ("xdeepfm", dict(cin_sizes=(32, 32), bf16=False)),
    # the shapes the card once refused (ROADMAP queue 3): the fused CIN at
    # dim 32, at widths 256 and at 100 (zero-padded to 112); DCN's x0 of
    # 1,053, the cross stack's wide-row path
    "xdeepfm_d32": ("xdeepfm", dict(cin_sizes=(128, 128), embed_dim=32)),
    "cin256": ("xdeepfm", dict(cin_sizes=(256, 256))),
    "cin100": ("xdeepfm", dict(cin_sizes=(100, 100))),
    "dcn": ("dcn", dict(n_cross=2)),
    "dcn_d40": ("dcn", dict(n_cross=3, embed_dim=40)),
    "afm": ("afm", dict(attention_dim=8)),
}


def _small_engine(path):
    """Small engines of every training path: slice 2 (CIN(32, 32), fused
    wide column, Adagrad), slice 3 (CIN(128, 128, 128), unfused wide table,
    lazy Adam), DeepFM, DCN and FM (slice 4), LR, PNN (mode both), Wide&Deep,
    NFM and AFM (slice 6), f32 xDeepFM (its CIN a layer at a time) and the
    repaired shapes of ``_SMALL_PATHS``, bench.py's dtypes."""
    from recmodels_tpu_torch.models import build_model
    from recmodels_tpu_torch.train.engine import Engine
    from recmodels_tpu_torch.utils.config import TrainConfig, build_schema

    model, kw = _SMALL_PATHS.get(path, (path, {}))
    cfg = TrainConfig(model=model, **{**dict(vocab_size=1000, embed_dim=16, hidden=(64, 64),
                                             bf16=path not in ("fm", "lr")), **kw})
    schema = build_schema(cfg)
    opts = dict(sparse_optimizer="adam", fuse_wide=False) if path == "slice3" else {}
    return Engine(build_model(model, schema, **cfg.model_kwargs()), **opts), schema, cfg


def _card_batches(schema, n, cuda, batch=512, seed=3):
    from recmodels_tpu_torch.data import SyntheticSource

    it = iter(SyntheticSource(schema, batch_size=batch, seed=seed))
    return [tuple(torch.as_tensor(a, device=cuda) for a in (b.dense, b.ids, b.labels))
            for b in (next(it) for _ in range(n))]


def _tensors(state):
    from recmodels_tpu_torch.utils.tree import leaves

    return [t for t in leaves(state) if isinstance(t, torch.Tensor)]


@pytest.mark.parametrize("path", ["slice2", "slice3", "deepfm", "dcn", "fm", "lr", "pnn", "widedeep", "nfm",
                                  "afm"])
def test_captured_steps_equal_eager_steps(cuda, path):
    """Five steps through ``jit_train_step`` (an eager warm-up, the capture
    and its replay, three replays) against five eager ``train_step``s from
    the same state: the same kernels on the same inputs, with lr and the
    bias corrections read from device memory, so the losses and every state
    tensor agree bit for bit; one graph is captured, and each returned loss
    is a copy."""
    eng, schema, _ = _small_engine(path)
    eager, captured = eng.init(seed=0, device=cuda), eng.init(seed=0, device=cuda)
    ts = eng.jit_train_step()
    losses = []
    for b in _card_batches(schema, 5, cuda):
        eager, me = eng.train_step(eager, *b)
        captured, mc = ts(captured, *b)
        losses.append((me["loss"], mc["loss"]))
    torch.cuda.synchronize()
    assert ts.graphs == 1 and int(captured.step) == 5
    for want, got in losses:
        assert torch.equal(got, want)
    assert len({float(got) for _, got in losses}) == 5  # copies, not the graph's static output
    assert all(torch.equal(a, b) for a, b in zip(_tensors(captured), _tensors(eager)))


def test_captured_scan_equals_captured_steps(cuda):
    eng, schema, _ = _small_engine("slice2")
    bs = _card_batches(schema, 4, cuda)
    a, b = eng.init(seed=0, device=cuda), eng.init(seed=0, device=cuda)
    ts = eng.jit_train_step()
    stepwise = []
    for batch in bs:
        a, m = ts(a, *batch)
        stepwise.append(m["loss"])
    b, m = eng.jit_train_scan()(b, *(torch.stack([x[i] for x in bs]) for i in range(3)))
    torch.cuda.synchronize()
    assert torch.equal(m["losses"], torch.stack(stepwise)) and torch.equal(m["loss"], stepwise[-1])
    assert all(torch.equal(x, y) for x, y in zip(_tensors(a), _tensors(b)))


def test_captured_step_captures_again_for_another_state(cuda):
    """A second state gets graphs of its own: the first state's tensors keep
    their bits while the second trains, and the second's steps equal its
    eager steps."""
    eng, schema, _ = _small_engine("slice2")
    bs = _card_batches(schema, 3, cuda)
    first, second, eager = (eng.init(seed=s, device=cuda) for s in (0, 1, 1))
    ts = eng.jit_train_step()
    for b in bs:
        first, _ = ts(first, *b)
    kept = [t.clone() for t in _tensors(first)]
    for b in bs:
        second, _ = ts(second, *b)
        eager, _ = eng.train_step(eager, *b)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(_tensors(first), kept))
    assert all(torch.equal(x, y) for x, y in zip(_tensors(second), _tensors(eager)))


def test_replay_applies_the_next_steps_bias_corrections(cuda):
    """A graph of lazy Adam's scalar block, its update and the step's
    advance, replayed three times: each replay reads the step tensor as it
    stands, so it applies steps 1, 2, 3's bias corrections, bit for bit the
    plain version's three calls on the CPU."""
    table, acc, ids, grads = _stream(cuda, 3000, 16, 2000, 0.3, torch.bfloat16, seed=9)
    m, v = acc - 0.6, acc * 0.01
    step = torch.zeros((), dtype=torch.int32, device=cuda)
    lr = torch.tensor(1e-2, device=cuda)
    cpu = [t.cpu() for t in (table, m, v)]

    def one_step():
        sorted_adam_update(table, m, v, ids, grads, adam_scalars(lr, step, 0.9, 0.999), 0.9, 0.999, 1e-8)
        step.add_(1)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # builds the library and the constants outside the capture
        adam_scalars(lr, step, 0.9, 0.999)
        build.library()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        one_step()
    for k in range(3):
        graph.replay()
        sc = adam_scalars(lr.cpu(), torch.tensor(k, dtype=torch.int32), 0.9, 0.999)
        sorted_adam_update_reference(*cpu, ids.cpu(), grads.cpu(), sc, 0.9, 0.999, 1e-8)
    torch.cuda.synchronize()
    assert int(step) == 3
    for got, want in zip((table, m, v), cpu):
        assert torch.equal(got.cpu(), want)


def test_captured_predictor_matches_eager_logits(cuda, tmp_path):
    """The bucketed Predictor on the card (one graph a bucket, from 64):
    requests of 1, 100, 300 and 70 (buckets 64, 128, 512, 128 again) are bit
    for bit ``Engine.logits`` on the padded request, and within the serving
    tolerance (LOGIT_REL_TOL of the largest |logit|) of the unpadded
    request's."""
    from recmodels_tpu_torch.serve import export_model, load_predictor

    eng, schema, cfg = _small_engine("slice2")
    state = eng.init(seed=0, device=cuda)
    export_model(str(tmp_path), cfg, eng, state)
    pred = load_predictor(str(tmp_path), min_bucket=64, device="cuda")
    (dense, ids, _), = _card_batches(schema, 1, cuda, batch=300)
    for n in (1, 100, 300, 70):
        got = pred.predict_logits(dense[:n].cpu().numpy(), ids[:n].cpu().numpy())
        b = pred._bucket(n)
        pad_d = torch.zeros((b, dense.shape[1]), device=cuda)
        pad_i = torch.zeros((b, ids.shape[1]), dtype=torch.int32, device=cuda)
        pad_d[:n], pad_i[:n] = dense[:n], ids[:n]
        with torch.inference_mode():
            padded = pred.engine.logits(pred.state, pad_d, pad_i)[:n].cpu()
            unpadded = pred.engine.logits(pred.state, dense[:n], ids[:n]).cpu()
        assert torch.equal(torch.from_numpy(got), padded)
        assert (torch.from_numpy(got) - unpadded).abs().max() <= 1e-2 * unpadded.abs().max()
    assert sorted(pred._buckets) == [64, 128, 512]
    assert all(bk.graph is not None for bk in pred._buckets.values())
    # another state assigned to the scorer: its graphs are dropped and the
    # answers follow the new state's weights
    pred.state = eng.init(seed=1, device=cuda)._replace(dense_opt=None, emb_opt=None)
    got = pred.predict_logits(dense[:100].cpu().numpy(), ids[:100].cpu().numpy())
    pad_d = torch.zeros((128, dense.shape[1]), device=cuda)
    pad_i = torch.zeros((128, ids.shape[1]), dtype=torch.int32, device=cuda)
    pad_d[:100], pad_i[:100] = dense[:100], ids[:100]
    with torch.inference_mode():
        want = pred.engine.logits(pred.state, pad_d, pad_i)[:100].cpu()
    assert torch.equal(torch.from_numpy(got), want) and sorted(pred._buckets) == [128]


# ------------------------------------ the step and the scorer against the CPU
_FUSED_CIN = {gather_rows: True, K.split_fused_rows: True, K.cin2_forward: True, K.cin_layer_forward: False,
              bias_act: True}
_FUSED_CIN_STEP = {sorted_adagrad_update: True, K.split_fused_rows_backward: True, K.cin2_backward: True,
                   act_backward: True}
_ONE_TABLE = ({gather_rows: True}, {sorted_adagrad_update: True})
# each path's route: (the forward's kernels, the step's others), each kernel
# to True where it launches, False where it must not, n where one eager step
# launches it exactly n times (a served request: at least once)
_ROUTES = {
    "slice2": (_FUSED_CIN, _FUSED_CIN_STEP),
    "slice3": ({gather_rows: 2, K.cin_layer_forward: 3, K.cin2_forward: False, bias_act: 3},
               {K.transpose_minor2: True, K.cin_layer_backward: True, sorted_adam_update: 2, act_backward: 3}),
    "deepfm": ({gather_rows: True, K.fm_pairwise_forward: True, bias_act: 3},
               {sorted_adagrad_update: True, act_backward: 3}),
    "dcn": ({gather_rows: True, K.dcn_cross_stack_forward: True, bias_act: 2},
            {sorted_adagrad_update: True, act_backward: 2}),
    "fm": ({gather_rows: True, K.fm_pairwise_forward: True}, {sorted_adagrad_update: True}),
    "xdeepfm_f32": ({gather_rows: True, K.split_fused_rows: True, K.cin_layer_forward: 2, K.cin2_forward: False,
                     bias_act: False}, {sorted_adagrad_update: True, K.split_fused_rows_backward: True,
                                        act_backward: False}),
    "lr": _ONE_TABLE, "pnn": _ONE_TABLE, "widedeep": _ONE_TABLE, "nfm": _ONE_TABLE, "afm": _ONE_TABLE,
    "xdeepfm_d32": (_FUSED_CIN, _FUSED_CIN_STEP),
    "cin256": (_FUSED_CIN, _FUSED_CIN_STEP),
    "cin100": (_FUSED_CIN, _FUSED_CIN_STEP),
    "dcn_d40": ({gather_rows: True, K.dcn_cross_stack_forward: True, bias_act: 2},
                {sorted_adagrad_update: True, act_backward: 2}),
}
# the rows' scale in ``_liven``: the FM term and PNN's products grow with its
# square, 3 keeps those logits within a few units; AFM's pooled pairs, far
# smaller than the rows, grow with its cube (its p is scaled too), and 15
# lifts them past TERM_MIN_TOLS
_ROWS_SCALE = {"deepfm": 3.0, "fm": 3.0, "pnn": 3.0, "nfm": 3.0, "afm": 15.0}


def _liven(state, gen, scale, dim):
    """Give every kernel of the path a visible share of the logits, in
    place. ``Engine.init`` leaves the first-order column, ``w_dense``, the
    bias and DCN's cross biases at zero, and its N(0, 0.05) rows leave the
    second CIN pool near 1e-3 of a logit: a wrong ``wide_sum`` or p2 would
    pass a comparison with the CPU. Rows times ``scale``, a first-order
    column (the fused table's last, of ``dim + 1``, or the dim-1 ``wide``
    table) N(0, 0.2) and a drawn ``w_dense``, bias and cross bias fix that;
    AFM's attention-pooled pairs are far smaller than the rows, so its ``p``
    is scaled too."""
    wide = state.emb_params.get("wide", {})
    for table in state.emb_params.get("emb", {}).values():
        if wide or table.shape[1] != dim + 1:  # no fused first-order column
            table *= scale
        else:
            table[:, :-1] *= scale
            table[:, -1] = torch.randn(table.shape[0], generator=gen, device=table.device) * 0.2
    for table in wide.values():
        table.copy_(torch.randn(table.shape, generator=gen, device=table.device) * 0.2)
    dp, dev = state.dense_params, state.step.device
    if "w_dense" in dp:
        dp["w_dense"] = torch.randn(dp["w_dense"].shape, generator=gen, device=dev) * 0.1
    if "cross" in dp:
        dp["cross"]["b"] = torch.randn(dp["cross"]["b"].shape, generator=gen, device=dev) * 0.1
    if "p" in dp:
        dp["p"] = dp["p"] * scale
    if "bias" in dp:
        dp["bias"] = torch.randn((), generator=gen, device=dev) * 0.1


# each term a kernel of the path makes must move some logit by at least this
# many logit tolerances, so that a comparison with the CPU sees it go wrong
TERM_MIN_TOLS = 10.0


def _term_sizes(pred, dense, ids):
    """Largest |contribution| to a logit over the requests given of each
    term that a kernel of the path makes, through the predictor's own
    wrappers (the plain versions for a CPU predictor) and the model's own
    routes: xDeepFM's ``wide_sum``, p1 . w_cin and p2 . w_cin; the FM term
    of DeepFM and FM; what DCN's cross layers add beyond x0,
    (x_L - x0) . w_out; the first-order sum (all zoo models but PNN), PNN's
    products (the MLP of its input against the MLP of it with the product
    features zeroed), NFM's MLP of the bi-interaction against the MLP of
    zeros, AFM's attention-pooled pairs (the logit less its linear terms)."""
    from recmodels_tpu_torch.nn.mlp import mlp_apply
    from recmodels_tpu_torch.ops.dispatch import get_op
    from recmodels_tpu_torch.ops.interactions import fm_bi_interaction

    eng, st = pred.engine, pred.state
    model, dp = eng.model, st.dense_params
    cd = getattr(model, "compute_dtype", torch.float32)
    with torch.inference_mode():
        ids_t = torch.as_tensor(ids, device=pred.device)
        dense_t = torch.as_tensor(dense, device=pred.device)
        rows = eng.tables.gather(st.emb_params, eng._group_ids(ids_t), eng._gather_dtype)
        ((_, groups),) = rows.items()
        (full,) = groups.values()
        if model.name == "xdeepfm":
            x_dm, ws = K.split_fused_rows(full.to(cd), full.shape[2] - 1)
            pools = K.cin_stack_dm_flat(x_dm, [w.to(cd) for w in dp["cin_w"]]).float()
            h1 = model.cin_sizes[0]
            return {"wide_sum": ws.abs().max().item(),
                    "p1 . w_cin": (pools[:, :h1] @ dp["w_cin"][:h1]).abs().max().item(),
                    "p2 . w_cin": (pools[:, h1:] @ dp["w_cin"][h1:]).abs().max().item()}
        if model.name in ("deepfm", "fm"):
            return {"FM term": K.fm_pairwise_forward(full[..., :-1]).abs().max().item()}
        if model.name == "dcn":
            x0 = torch.cat([full.reshape(full.shape[0], -1), dense_t.to(cd)], dim=1)
            xl = K.dcn_cross_stack_forward(x0, dp["cross"]["w"].to(cd), dp["cross"]["b"].to(cd))
            return {"(x_L - x0) . w_out": ((xl.float() - x0.float()) @ dp["w_out"][: x0.shape[1]]).abs().max().item()}
        if model.name == "lr":
            return {"wide_sum": full.float().sum(dim=(1, 2)).abs().max().item()}
        if model.name == "pnn":
            b = full.shape[0]
            z = [full.reshape(b, -1), dense_t.to(full.dtype)]
            parts = []
            if model.mode in ("inner", "both"):
                parts.append(get_op("pnn_inner_products")(full))
            if model.mode in ("outer", "both"):
                parts.append(get_op("pnn_outer_product")(full).reshape(b, -1))
            p = torch.cat(parts, dim=1)
            y, y0 = (mlp_apply(dp["mlp"], torch.cat(z + [q], dim=1), final_linear=True, compute_dtype=cd)
                     for q in (p, torch.zeros_like(p)))
            return {"products": (y - y0).abs().max().item()}
        e, wide = full[..., :-1], full[..., -1:].float()
        ws = wide[..., 0].sum(dim=1)
        out = {"wide_sum": ws.abs().max().item()}
        if model.name == "nfm":
            bi = fm_bi_interaction(e)
            y, y0 = (mlp_apply(dp["mlp"], q, final_linear=True, compute_dtype=cd) for q in (bi, torch.zeros_like(bi)))
            out["MLP(bi) - MLP(0)"] = (y - y0).abs().max().item()
        if model.name == "afm":
            logit = model.apply(dp, dense_t, {"emb": e, "wide": wide})
            out["p . pooled"] = (logit - (dp["bias"] + ws + dense_t @ dp["w_dense"])).abs().max().item()
        return out


def _launched(route, before):
    """Each kernel of ``route`` launched as it says since ``before`` (the
    counts then): any number for True, none for False, exactly n for n."""
    for k, want in route.items():
        n = k.launches - before[k]
        assert n == want if type(want) is int else (n > 0) is want, f"{k.__name__}: {n} launches, want {want}"


def _held_to_the_cpu(what, got, want, before):
    """A tensor of the card's step within STEP_REL_TOL of the CPU step's
    largest change of it."""
    got, want, before = got.cpu().float(), want.float(), before.float()
    err, change = (got - want).abs().max().item(), (want - before).abs().max().item()
    assert change > 0 and err <= STEP_REL_TOL * change, f"{what}: err {err:.6g}, change {change:.6g}"


def _adam_step_of(before, m, v, scalars):
    """The table after lazy Adam's step from its new moments (on the CPU, in
    the update's order of operations and f32 constants), with the step's
    [lr, bc1, bc2] as the card computed them."""
    c = adam_constants(0.9, 0.999, 1e-8)
    lr, bc1, bc2 = scalars.cpu().unbind()
    return before + (-lr * (m / bc1)) / (torch.sqrt((v / bc2).double()).float() + c["eps"])


def _step_matches_the_cpu(cuda, path):
    """One step of ``_small_engine(path)`` from a live state at 512
    examples on the card and on the CPU's plain path; see
    ``test_step_on_the_card_matches_the_cpu``."""
    eng, schema, cfg = _small_engine(path)
    card = eng.init(seed=0, device=cuda)
    _liven(card, _gen(cuda, 31), _ROWS_SCALE.get(path, 10.0), cfg.embed_dim)
    before, cpu = _to_cpu_state(card), _to_cpu_state(card)
    (b,) = _card_batches(schema, 1, cuda)
    dense, ids, labels = (t.cpu() for t in b)
    route = {**_ROUTES[path][0], **_ROUTES[path][1]}
    counts = {k: k.launches for k in route}
    card, mc = eng.train_step(card, *b)
    torch.cuda.synchronize()
    _launched(route, counts)
    cpu, mh = eng.train_step(cpu, dense, ids, labels)
    with torch.no_grad():
        max_logit = eng.logits(before, dense, ids).abs().max().item()
    assert abs(mc["loss"].item() - mh["loss"].item()) <= LOGIT_REL_TOL * max_logit
    # Adam's moments hold the dense grads; its step m / (sqrt(v) + eps) is
    # near lr * sign(g) where this step's grads outgrow the history (as
    # after _liven), so the params are not compared
    for name in ("mu", "nu"):
        for j, leaves in enumerate(zip(card.dense_opt[name], cpu.dense_opt[name], before.dense_opt[name])):
            _held_to_the_cpu(f"Adam {name} leaf {j}", *leaves)
    for cname, coll in eng.collections.items():
        for grp in coll.groups:
            def rows(st, key=None):  # a dim-1 table as [R, 1]
                t = st.emb_params[cname][grp.name] if key is None else st.emb_opt[cname][grp.name][key]
                return t.cpu().reshape(t.shape[0], -1)

            keys = [None, *card.emb_opt[cname][grp.name]]
            got, want, old = ({k: rows(st, k) for k in keys} for st in (card, cpu, before))
            touched = torch.zeros(old[None].shape[0], dtype=torch.bool)
            touched[coll.group_row_ids(ids)[grp.name].reshape(-1).long()] = True
            for k in keys:
                assert torch.equal(got[k][~touched], old[k][~touched]), (cname, k, "untouched rows")
                assert torch.equal(want[k][~touched], old[k][~touched]), (cname, k, "untouched rows")
            if "m" in got:  # lazy Adam normalises each grad: the table moves by its own moments' step
                for k in ("m", "v"):
                    _held_to_the_cpu(f"{cname} {k}", got[k][touched], want[k][touched], old[k][touched])
                scalars = adam_scalars(torch.tensor(eng.emb_lr, device=cuda), before.step.to(cuda), 0.9, 0.999)
                assert torch.equal(got[None][touched], _adam_step_of(old[None][touched], got["m"][touched],
                                                                     got["v"][touched], scalars))
                continue
            # the fused first-order column's grads outgrow the embedding
            # columns': each part is held to its own largest change
            parts = ((slice(0, -1), slice(-1, None)) if old[None].shape[1] == cfg.embed_dim + 1
                     else (slice(None),))
            for k in keys:
                for cols in parts:
                    _held_to_the_cpu(f"{cname} {k or 'table'} {cols}", got[k][touched, cols],
                                     want[k][touched, cols], old[k][touched, cols])


def _to_cpu_state(state):
    return type(state)(*(_to_cpu(x) for x in state))


_STEP_PATHS = ["slice2", "slice3", "deepfm", "dcn", "fm", "xdeepfm_f32", "lr", "pnn", "widedeep", "nfm", "afm",
               "xdeepfm_d32", "cin256", "cin100", "dcn_d40"]


@pytest.mark.parametrize("path", [p for p in _STEP_PATHS if p != "slice3"])  # an artifact has no fuse_wide
def test_served_logits_on_the_card_match_the_cpu(cuda, path, tmp_path):
    """A live state (``_liven``) exported and served by ``load_predictor``
    on the card and on the CPU: at 512 requests the card's logits are
    finite, bit for bit eager ``Engine.logits`` on the request padded to its
    bucket, whose graph is the scorer's one, and within LOGIT_REL_TOL of the
    largest |logit| of the CPU's plain path; the forward's kernels of the
    path's route launch, those it names False do not; each term a kernel
    makes (``_term_sizes``, on the CPU) moves some logit by TERM_MIN_TOLS
    of that tolerance, so the comparison would see it go wrong."""
    from recmodels_tpu_torch.serve import export_model, load_predictor

    eng, schema, cfg = _small_engine(path)
    state = eng.init(seed=0, device=cuda)
    _liven(state, _gen(cuda, 37), _ROWS_SCALE.get(path, 10.0), cfg.embed_dim)
    export_model(str(tmp_path), cfg, eng, state)
    (dense, ids, _), = _card_batches(schema, 1, cuda, seed=9)
    pred = load_predictor(str(tmp_path), device="cuda")
    forward = {k: bool(want) for k, want in _ROUTES[path][0].items()}
    counts = {k: k.launches for k in forward}
    got = pred.predict_logits(dense.cpu().numpy(), ids.cpu().numpy())
    torch.cuda.synchronize()
    _launched(forward, counts)
    bucket = pred._bucket(512)
    assert np.all(np.isfinite(got)) and sorted(pred._buckets) == [bucket] and pred._buckets[bucket].graph is not None
    pad_d = torch.zeros((bucket, dense.shape[1]), device=cuda)
    pad_i = torch.zeros((bucket, ids.shape[1]), dtype=torch.int32, device=cuda)
    pad_d[:512], pad_i[:512] = dense, ids
    with torch.inference_mode():
        assert torch.equal(torch.from_numpy(got), pred.engine.logits(pred.state, pad_d, pad_i)[:512].cpu())
    cpu_pred = load_predictor(str(tmp_path), device="cpu")
    want = cpu_pred.predict_logits(dense.cpu().numpy(), ids.cpu().numpy())
    tol = LOGIT_REL_TOL * np.abs(want).max()
    assert np.abs(got - want).max() <= tol
    for name, size in _term_sizes(cpu_pred, dense.cpu(), ids.cpu()).items():
        assert size >= TERM_MIN_TOLS * tol, f"{name}: {size:.6g} < {TERM_MIN_TOLS} x the logit tolerance {tol:.6g}"


# ---------------------------------------------------------------- slice 6
def test_gather_kernel_on_lrs_one_column_f32_rows(cuda):
    """#1 as LR runs it: the 1-D dim-1 table (viewed [R, 1]) at 26 slots x
    16,384 batch-order ids, f32 rows: one launch, bit for bit the plain
    version."""
    g = _gen(cuda, 61)
    rows = 2_600_960
    table = torch.randn((rows,), generator=g, device=cuda) * 0.2
    ids = torch.randint(0, rows, (16_384, 26), generator=g, device=cuda, dtype=torch.int32)
    _gather_checked(table.reshape(rows, 1), ids, torch.float32)


@pytest.mark.parametrize("dim,grad_dtype", [(16, torch.bfloat16), (1, torch.float32)],
                         ids=["pnn_d16_bf16", "lr_d1_f32"])
def test_adagrad_update_kernel_on_the_zoo_streams(cuda, dim, grad_dtype):
    """#4 at PNN's 16 columns with bf16 grads and #8 at LR's dim-1 table
    with f32 grads, on a stream of the flagship's size (425,984 sorted ids
    into 2,600,960 rows, duplicates and sentinels): bit for bit the plain
    version on the CPU."""
    table, acc, ids, grads = _stream(cuda, 2_600_960, dim, 425_984, 0.05, grad_dtype, seed=62)
    lr = torch.tensor(1e-2, device=cuda)
    t_cpu, a_cpu = table.cpu(), acc.cpu()
    sorted_adagrad_update_reference(t_cpu, a_cpu, ids.cpu(), grads.cpu(), lr.cpu(), 1e-8)
    before = sorted_adagrad_update.launches
    sorted_adagrad_update(table, acc, ids, grads, lr, 1e-8)
    torch.cuda.synchronize()
    assert sorted_adagrad_update.launches == before + 1
    assert torch.equal(table.cpu(), t_cpu) and torch.equal(acc.cpu(), a_cpu)


@pytest.mark.parametrize("path", ["deepfm", "afm", "lr"])
def test_captured_eval_equals_eager_eval(cuda, path):
    """Four eval batches through ``jit_eval_step`` (warm-up, capture,
    replays) and three masked batches (a weight of 0/1: a shape of its own,
    so its warm-up, capture and a replay) against ``eval_step`` from the
    same AUC state: the int32 histograms, the count and the loss sum bit for
    bit; the CPU's ``auc_update`` on the card's logits gives the same
    histograms."""
    from recmodels_tpu_torch.train.metrics import auc_init, auc_update

    eng, schema, _ = _small_engine(path)
    state = eng.init(seed=0, device=cuda)
    es = eng.jit_eval_step()
    eager, captured, cpu = auc_init(device=cuda), auc_init(device=cuda), auc_init(device="cpu")
    weight = (torch.arange(512, device=cuda) < 300).float()
    for k, b in enumerate(_card_batches(schema, 7, cuda, seed=5)):
        w = weight if k >= 4 else None
        eng.eval_step(state, eager, *b, w)
        assert es(state, captured, *b, w) is captured
        with torch.no_grad():
            z = eng.logits(state, b[0], b[1]).cpu()
        auc_update(cpu, z, b[2].cpu(), None if w is None else w.cpu())
    torch.cuda.synchronize()
    assert es.graphs == 2 and int(captured.count) == 4 * 512 + 3 * 300
    for x, y, c in zip(eager, captured, cpu):
        assert torch.equal(x, y)
        if x.dtype == torch.int32:
            assert torch.equal(x.cpu(), c)
    torch.testing.assert_close(eager.loss_sum.cpu(), cpu.loss_sum, rtol=1e-5, atol=0)


# ------------------------------------------------- slice 7: the entry point
@pytest.mark.parametrize("path", ["slice2", "slice3"])
def test_captured_accumulated_steps_equal_eager_ones(cuda, path):
    """Four ``jit_train_step_accum`` steps of two micro-batches of 256
    (warm-up, capture, replays) against four eager ``train_step_accum``s:
    the losses and every state tensor bit for bit; then
    ``jit_train_scan_accum`` over the same batches gives those losses."""
    eng, schema, _ = _small_engine(path)
    bs = [tuple(t.reshape(2, 256, *t.shape[1:]) for t in b) for b in _card_batches(schema, 4, cuda)]
    eager, captured, scanned = (eng.init(seed=0, device=cuda) for _ in range(3))
    ts = eng.jit_train_step_accum()
    losses = []
    for b in bs:
        eager, me = eng.train_step_accum(eager, *b)
        captured, mc = ts(captured, *b)
        assert torch.equal(me["loss"], mc["loss"])
        losses.append(mc["loss"])
    scanned, m = eng.jit_train_scan_accum()(scanned, *(torch.stack([x[i] for x in bs]) for i in range(3)))
    torch.cuda.synchronize()
    assert ts.graphs == 1 and int(captured.step) == 4
    assert all(torch.equal(a, b) for a, b in zip(_tensors(captured), _tensors(eager)))
    assert torch.equal(m["losses"], torch.stack(losses))
    assert all(torch.equal(a, b) for a, b in zip(_tensors(scanned), _tensors(eager)))


def test_captured_scheduled_steps_equal_eager_ones(cuda):
    """Six ``jit_train_step``s on a warmup-and-cosine schedule (both lrs
    change every step; a lr frozen into the graph would show from the
    third) with adamw's decay, against eager ``train_step``s: bit for bit,
    the schedule's count advancing in the state."""
    from recmodels_tpu_torch.models import build_model
    from recmodels_tpu_torch.train.engine import Engine
    from recmodels_tpu_torch.train.schedules import build_lr_schedule

    _, schema, cfg = _small_engine("slice2")
    sched = dict(kind="cosine", warmup_steps=3, total_steps=6)
    eng = Engine(build_model("xdeepfm", schema, **cfg.model_kwargs()),
                 dense_lr_schedule=build_lr_schedule(1e-3, **sched),
                 emb_lr_schedule=build_lr_schedule(1e-2, **sched), dense_weight_decay=1e-4)
    eager, captured = eng.init(seed=0, device=cuda), eng.init(seed=0, device=cuda)
    ts = eng.jit_train_step()
    for b in _card_batches(schema, 6, cuda):
        eager, me = eng.train_step(eager, *b)
        captured, mc = ts(captured, *b)
        assert torch.equal(me["loss"], mc["loss"])
    torch.cuda.synchronize()
    assert ts.graphs == 1 and int(captured.dense_opt["schedule_count"]) == 6
    assert all(torch.equal(a, b) for a, b in zip(_tensors(captured), _tensors(eager)))


def test_checkpoint_round_trip_of_a_card_state(cuda, tmp_path):
    """A CUDA state saved, trained on in place while the write runs, and
    restored into another CUDA state's own tensors: the saved bits, the
    addresses kept; a graph captured on the target before the restore then
    continues from the restored state as eager steps do."""
    from recmodels_tpu_torch.train.checkpoint import CheckpointManager

    eng, schema, _ = _small_engine("slice3")
    bs = _card_batches(schema, 4, cuda)
    state = eng.init(seed=0, device=cuda)
    state, _ = eng.train_step(state, *bs[0])
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, state, {"step": 1})
    saved = [t.clone() for t in _tensors(state)]
    state, _ = eng.train_step(state, *bs[1])
    target = eng.init(seed=5, device=cuda)
    ts = eng.jit_train_step()
    for b in bs[:2]:
        target, _ = ts(target, *b)  # warm-up and capture on the target's tensors
    ptrs = [t.data_ptr() for t in _tensors(target)]
    restored, data = mgr.restore(target)
    torch.cuda.synchronize()
    assert restored is target and data == {"step": 1}
    assert [t.data_ptr() for t in _tensors(target)] == ptrs
    assert all(torch.equal(a, b) for a, b in zip(_tensors(target), saved))
    eager = eng.init(seed=5, device=cuda)
    mgr.restore(eager)
    for b in bs[2:]:
        target, mc = ts(target, *b)
        eager, me = eng.train_step(eager, *b)
        assert torch.equal(mc["loss"], me["loss"])
    torch.cuda.synchronize()
    assert ts.graphs == 1
    assert all(torch.equal(a, b) for a, b in zip(_tensors(target), _tensors(eager)))


# the loop's CLIs at a small shape; past WATCHDOG_S every thread's stack goes
# to stderr and the process exits (ROADMAP queue 3: the training loop hung
# once on the card, with no traceback)
WATCHDOG_S = 300
CRITEO_SAMPLE = os.path.join(os.path.dirname(__file__), "fixtures", "criteo_sample.tsv")


@contextlib.contextmanager
def _watchdog():
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True, file=sys.__stderr__)
    try:
        yield
    finally:
        faulthandler.cancel_dump_traceback_later()


def _cli_args(batch=512):
    """bf16 xDeepFM, CIN(32, 32), DNN(64, 64) over 26 slots of 1,000 ids,
    the engine's optimizers, adamw decay, superbatches of 5."""
    return ["--model", "xdeepfm", "--batch-size", str(batch), "--set", "bf16=True", "--set", "vocab_size=1000",
            "--set", "embed_dim=16", "--set", "cin_sizes=(32, 32)", "--set", "hidden=(64, 64)",
            "--set", "scan_steps=5", "--set", "log_every=5", "--set", "producer_workers=1",
            "--set", "dense_weight_decay=1e-4"]


def _logged(out, kind):
    """(step, scalars) of each ``step N <kind> {...}`` line a logger wrote."""
    import json

    return [(int(m.group(1)), json.loads(m.group(2))) for m in re.finditer(rf"step +(\d+) {kind} (\{{.*\}})", out)]


@pytest.mark.parametrize("data", ["synthetic", "device_synth"])
def test_cli_train_resume_export_predict_on_the_card(cuda, tmp_path, capsys, data):
    """``cli.train`` on the card, host-fed or generated on the card, under a
    watchdog: 40 steps with checkpoints every 10 and eval of 2 held-out
    batches at the end launch the step's kernels inside the Trainer (and
    the batch kernel, generated); the last logged loss is below the first,
    val AUC and logloss finite, checkpoint 40 the latest. 20 steps, then a
    new run resuming them to 40, end bit for bit on the straight run's
    state. Host-fed: ``cli.export`` of checkpoint 40 and ``cli.predict`` of
    two synthetic batches with the artifact give sigmoid(``Engine.logits``)
    of the restored checkpoint, within a quarter of LOGIT_REL_TOL of the
    largest |logit| (the sigmoid moves by at most a quarter of its
    argument's change)."""
    from recmodels_tpu_torch.cli import export as export_cli
    from recmodels_tpu_torch.cli import predict as predict_cli
    from recmodels_tpu_torch.cli import train as train_cli
    from recmodels_tpu_torch.data import SyntheticSource
    from recmodels_tpu_torch.data import device_synth as ds
    from recmodels_tpu_torch.train.loop import Trainer
    from recmodels_tpu_torch.utils.config import TrainConfig
    from recmodels_tpu_torch.utils.tree import leaves

    common = _cli_args() + ["--data", data, "--set", "ckpt_every=10", "--set", "eval_every=40",
                            "--set", "eval_batches=2"]
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    route = {**_FUSED_CIN, **_FUSED_CIN_STEP, **({ds.synth_batch: True} if data == "device_synth" else {})}
    counts = {k: k.launches for k in route}
    with _watchdog():
        assert train_cli.main(common + ["--steps", "40", "--ckpt-dir", a]) == 0
        out = capsys.readouterr().out
        _launched(route, counts)
        assert train_cli.main(common + ["--steps", "20", "--ckpt-dir", b]) == 0
        assert train_cli.main(common + ["--steps", "40", "--ckpt-dir", b]) == 0
    assert "resumed from checkpoint at step 20" in capsys.readouterr().out
    train, val = _logged(out, "train"), _logged(out, "val")
    assert len(train) >= 2 and train[-1][1]["loss"] < train[0][1]["loss"], train
    assert len(val) == 1 and all(np.isfinite(val[0][1][k]) for k in ("auc", "logloss")), val
    for ckpt in (a, b):
        assert max(int(d) for d in os.listdir(ckpt) if d.isdigit()) == 40
    straight, resumed = (torch.load(os.path.join(d, "40", "state.pt"), map_location="cpu", weights_only=True)
                         for d in (a, b))
    assert all(torch.equal(x, y) for x, y in zip(leaves(straight), leaves(resumed), strict=True))
    if data != "synthetic":
        return
    art, preds = str(tmp_path / "art"), str(tmp_path / "preds.txt")
    with _watchdog():
        assert export_cli.main(["--ckpt-dir", a, "--out", art]) == 0
        assert predict_cli.main(["--model-dir", art, "--data", "synthetic", "--max-batches", "2", "--out", preds]) == 0
    probs = np.loadtxt(preds)
    cfg = TrainConfig.from_json(open(os.path.join(a, "config.json")).read())
    trainer = Trainer(cfg.apply_overrides([f"ckpt_dir={a!r}"]))
    state, _ = trainer.ckpt.restore(trainer.engine.init(seed=cfg.seed, device=trainer.device))
    assert int(state.step) == 40 and probs.shape == (1024,)
    src = iter(SyntheticSource(trainer.schema, batch_size=512, seed=cfg.seed))
    with torch.no_grad():
        z = torch.cat([trainer.engine.logits(state, *(torch.as_tensor(x, device=cuda) for x in (bt.dense, bt.ids)))
                       for bt in (next(src) for _ in range(2))]).double().cpu().numpy()
    assert np.abs(probs - 1.0 / (1.0 + np.exp(-z))).max() <= 0.25 * LOGIT_REL_TOL * np.abs(z).max() + 5e-7


def test_cli_on_the_criteo_sample_on_the_card(cuda, tmp_path, capsys):
    """``cli.train`` of 4 steps of 32 on the Criteo sample through the
    native parser, then ``cli.predict`` of its 96 rows from the checkpoint,
    under a watchdog: 96 probabilities in (0, 1), scored."""
    from recmodels_tpu_torch.cli import predict as predict_cli
    from recmodels_tpu_torch.cli import train as train_cli

    ckpt, preds = str(tmp_path / "ckpt"), str(tmp_path / "preds.txt")
    with _watchdog():
        assert train_cli.main(_cli_args(32) + ["--data", CRITEO_SAMPLE, "--steps", "4", "--ckpt-dir", ckpt,
                                               "--set", "scan_steps=2", "--set", "eval_every=0"]) == 0
        assert predict_cli.main(["--ckpt-dir", ckpt, "--data", CRITEO_SAMPLE, "--batch-size", "32",
                                 "--out", preds]) == 0
    probs = np.loadtxt(preds)
    assert probs.shape == (96,) and np.all((probs > 0) & (probs < 1))
    assert "eval n=96 auc=" in capsys.readouterr().out


# ------------------------------------------- slice 8: in-graph generation
def _synth_check(fn, step, cuda):
    """The batch kernel against its plain version on the card at batch
    ``step`` of ``fn``'s stream: one launch; the raw draws and the ids bit
    for bit; dense within one ulp (both take the card's log1pf); a label
    differs only where its uniform lies within 1e-6 of its probability (the
    logit and its mean summed in another order). Returns the kernel's
    batch."""
    from recmodels_tpu_torch.data import device_synth as ds

    st = torch.tensor(step, dtype=torch.int32, device=cuda)
    before = ds.synth_batch.launches
    d, i, l, bits = fn(st, with_bits=True)
    torch.cuda.synchronize()
    assert ds.synth_batch.launches == before + 1
    w, proj, vocab = fn.task(st.device)
    pd, pi, pl, pbits = ds.synth_batch_reference(st, fn.seed, w, proj, vocab, fn.batch_size, with_bits=True)
    assert torch.equal(bits.long() & ds.M32, pbits) and torch.equal(i, pi)
    assert (d.view(torch.int32) - pd.view(torch.int32)).abs().max().item() <= 1
    z = ds.planted_logit(pd, ds.bucket_weight(pi), w, proj)
    p = torch.sigmoid(z - z.mean())
    u = ds.bits_to_unit(pbits[:, -1])
    differ = l != pl
    assert bool(((u - p).abs()[differ] < 1e-6).all()), differ.sum().item()
    return d, i, l


def _synth_schema(name):
    """The flagship's schema (13 dense, 26 slots of 1e5 ids), or one of 5
    dense features and 10 slots of vocabs 7 to 2^31 - 1."""
    from recmodels_tpu_torch.data.schema import FeatureSpec, Schema, criteo_schema

    if name == "flagship":
        return criteo_schema(vocab_size=100_000, embed_dim=16)
    vocabs = [7] * 4 + [300] * 5 + [2**31 - 1]
    return Schema(n_dense=5, slots=tuple(FeatureSpec(f"c{i}", v, 8) for i, v in enumerate(vocabs)))


@pytest.mark.parametrize("b,schema,signal_dim", [(16_384, "flagship", 4), (1_000, "ten-slots", 3)])
@pytest.mark.parametrize("step", [0, 1, 2**31 - 1])
def test_device_synth_kernel_matches_its_plain_version(cuda, b, schema, signal_dim, step):
    """At the flagship's schema and B = 16,384, and at a ragged batch (not a
    multiple of the block's 64 examples) of a schema with 5 dense features,
    10 slots of vocabs up to 2^31 - 1 and a signal of 3 dimensions."""
    from recmodels_tpu_torch.data import device_synth as ds

    schema = _synth_schema(schema)
    fn = ds.make_device_batch_fn(schema, b, seed=5, signal_dim=signal_dim)
    d, i, l = _synth_check(fn, step, cuda)
    assert d.shape == (b, schema.n_dense) and i.shape == (b, schema.n_slots) and l.shape == (b,)
    vocab = torch.tensor(schema.vocab_sizes, device=cuda)
    assert bool((i >= 0).all()) and bool((i < vocab).all()) and 0.2 < l.mean().item() < 0.8


def test_device_synth_kernel_reads_the_step_when_it_runs(cuda):
    """A graph of the kernel and the step's advance, replayed twice from
    step s: the replays draw batches s and s + 1, bit for bit the eager
    kernel's."""
    from recmodels_tpu_torch.data import device_synth as ds
    from recmodels_tpu_torch.data.schema import criteo_schema

    fn = ds.make_device_batch_fn(criteo_schema(vocab_size=1000, embed_dim=8), 512, seed=2)
    step = torch.tensor(41, dtype=torch.int32, device=cuda)
    want = [fn(torch.tensor(s, dtype=torch.int32, device=cuda)) for s in (41, 42)]  # also builds, outside
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn(step)
        step.add_(1)
    for k in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(out, want[k]))
    assert int(step) == 43


@pytest.mark.parametrize("path", ["slice2", "deepfm"])
def test_captured_generated_steps_equal_eager_ones(cuda, path):
    """``jit_train_scan_gen`` (an eager warm-up, the capture, replays; the
    batch index is the state's step) over superbatches of 3 and a ragged 2
    against eager ``train_scan_gen`` from the same step: the losses and
    every state tensor bit for bit, one graph, and eight launches of the
    batch kernel counted: the five eager steps', the warm-up's, the
    capture's and its timed twin's (replays are not counted)."""
    from recmodels_tpu_torch.data import device_synth as ds

    eng, schema, _ = _small_engine(path)
    fn = ds.make_device_batch_fn(schema, 512, seed=6)
    eager, captured = eng.init(seed=0, device=cuda), eng.init(seed=0, device=cuda)
    scan = eng.jit_train_scan_gen(fn)
    before = ds.synth_batch.launches
    for k in (3, 2):
        eager, me = eng.train_scan_gen(eager, int(eager.step), k=k, batch_fn=fn)
        captured, mc = scan(captured, k)
        assert torch.equal(me["losses"], mc["losses"])
    torch.cuda.synchronize()
    assert scan.steps.graphs == 1 and int(captured.step) == 5
    assert ds.synth_batch.launches - before == 5 + 3
    assert all(torch.equal(a, b) for a, b in zip(_tensors(captured), _tensors(eager)))


def test_captured_generated_eval_equals_eager_eval(cuda):
    """``jit_eval_gen`` (generate batch ``index``, score it, advance
    ``index``; one graph) over four batches against ``eval_step`` on
    ``batch_fn(0..3)``: the AUC state bit for bit."""
    from recmodels_tpu_torch.data import device_synth as ds
    from recmodels_tpu_torch.train.metrics import auc_init

    eng, schema, _ = _small_engine("slice2")
    state, fn = eng.init(seed=0, device=cuda), ds.make_device_batch_fn(schema, 512, seed=7)
    eager, captured = auc_init(device=cuda), auc_init(device=cuda)
    index = torch.zeros((), dtype=torch.int32, device=cuda)
    eval_gen = eng.jit_eval_gen(fn)
    for k in range(4):
        eng.eval_step(state, eager, *fn(torch.tensor(k, dtype=torch.int32, device=cuda)))
        eval_gen(state, captured, index)
    torch.cuda.synchronize()
    assert eval_gen.captured.graphs == 1 and int(index) == 4 and int(captured.count) == 4 * 512
    assert all(torch.equal(a, b) for a, b in zip(eager, captured))


# ------------------------------------------ the sharded path (slice 9)
@pytest.fixture(scope="module")
def nccl_mesh():
    """The mesh of an NCCL process group of one rank on the card, formed by
    ``multihost.initialize``."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    import socket

    import torch.distributed as dist

    from recmodels_tpu_torch.parallel import make_mesh, multihost

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    multihost.initialize(f"127.0.0.1:{port}", 1, 0)
    try:
        assert dist.get_backend() == "nccl" and torch.cuda.current_device() == 0
        yield make_mesh(1)
    finally:
        dist.destroy_process_group()


def _sharded_twin(path, mesh, capacity_factor=1.25):
    """``_small_engine(path)``'s model as a sharded engine over ``mesh``."""
    from recmodels_tpu_torch.models import build_model
    from recmodels_tpu_torch.parallel import build_parallel_engine

    eng, schema, cfg = _small_engine(path)
    opts = dict(sparse_optimizer="adam", fuse_wide=False) if path == "slice3" else {}
    model = build_model(cfg.model, schema, **cfg.model_kwargs())
    return eng, build_parallel_engine(model, mesh, capacity_factor=capacity_factor, **opts), schema


@pytest.mark.parametrize("path", ["slice2", "slice3"])
def test_sharded_steps_equal_local_steps_on_the_card(cuda, nccl_mesh, path):
    """In an NCCL world of one, five sharded steps (eager, then captured by
    ``build_parallel_steps``, NCCL's collectives inside the graph) equal five
    local steps from one start state bit for bit: every loss and every
    tensor of the state; the overflow is 0 and the step launches the gather
    and the sparse update."""
    from recmodels_tpu_torch.parallel import build_parallel_steps, shard_state

    local_eng, eng, schema = _sharded_twin(path, nccl_mesh)
    start = eng.init(seed=0, device=cuda)
    local = shard_state(start, nccl_mesh)  # a copy: at world 1 a local state too
    eager, captured = shard_state(start, nccl_mesh), shard_state(start, nccl_mesh)
    train, _ = build_parallel_steps(eng, nccl_mesh)
    update = sorted_adam_update if path == "slice3" else sorted_adagrad_update
    for b in _card_batches(schema, 5, cuda):
        local, ml = local_eng.train_step(local, *b)
        gathers, updates = gather_rows.launches, update.launches
        eager, me = eng.train_step(eager, *b)
        assert gather_rows.launches > gathers and update.launches > updates
        captured, mc = train(captured, *b)
        assert torch.equal(me["loss"], ml["loss"]) and torch.equal(mc["loss"], ml["loss"])
        assert int(me["overflow"]) == 0 and int(mc["overflow"]) == 0
    torch.cuda.synchronize()
    assert train.captured.graphs == 1
    for state in (eager, captured):
        assert all(torch.equal(a, b) for a, b in zip(_tensors(state), _tensors(local)))


@pytest.mark.parametrize("capacity_factor", [1.25, 0.05])
def test_owner_gather_of_clamped_ids(cuda, nccl_mesh, capacity_factor):
    """The owner's gather runs the row-gather kernel on its receive stream
    with the sentinel tail clamped to the last row (the kernel's contract:
    every id in range), bit for bit its plain version; the requester's rows
    are the local gather's, and at a capacity factor of 0.05 the overflowed
    lookups, and only they, are zero rows."""
    _, eng, schema = _sharded_twin("slice2", nccl_mesh, capacity_factor)
    state = eng.init(seed=0, device=cuda)
    (dense, ids, _), = _card_batches(schema, 1, cuda)
    gids = eng._group_ids(ids)
    plan = eng.tables.plan(gids)["emb"]["d17"]
    table = state.emb_params["emb"]["d17"]
    rows = table.shape[0]
    tail = capacity_factor > 1  # a bucket past the batch's ids ends in sentinels, clamped to the last row
    assert (int(plan.stream_ids.max()) == rows) == tail and (int(plan.gather_ids.max()) == rows - 1) == tail
    got = gather_rows(table, plan.gather_ids, torch.bfloat16)
    assert torch.equal(got, gather_rows_reference(table, plan.gather_ids, torch.bfloat16))
    out, overflow = eng.tables.gather_with_stats(state.emb_params, gids)
    want = gather_rows(table, gids["emb"]["d17"], torch.float32).reshape(-1, table.shape[1])
    out = out["emb"]["d17"].reshape(-1, table.shape[1])
    zero = ~out.any(dim=1)
    assert int(zero.sum()) == int(overflow) and (int(overflow) > 0) == (capacity_factor < 1)
    assert torch.equal(out[~zero], want[~zero])


def test_sharded_scan_eval_and_overflow_on_the_card(cuda, nccl_mesh):
    """In the NCCL world of one, from one start state: each eager sharded
    step launches the kernels of the flagship's step; ``build_parallel_scan``
    over the same four batches gives their losses bit for bit, overflow 0;
    ``build_parallel_steps``' eval of the trained state adds the local
    engine's ``jit_eval_step`` AUC state bit for bit; at a capacity factor
    of 0.05 ``gather_with_stats`` drops as many lookups as the CPU's plain
    sharded engine (a gloo group of one beside the NCCL one), whose rows are
    the card's bit for bit."""
    import torch.distributed as dist

    from recmodels_tpu_torch.parallel import build_parallel_scan, build_parallel_steps, make_mesh, shard_state
    from recmodels_tpu_torch.train.metrics import auc_init

    local_eng, eng, schema = _sharded_twin("slice2", nccl_mesh)
    start = eng.init(seed=0, device=cuda)
    eager, scanned, local = (shard_state(start, nccl_mesh) for _ in range(3))
    bs = _card_batches(schema, 4, cuda)
    route = {**_ROUTES["slice2"][0], **_ROUTES["slice2"][1]}
    losses = []
    for b in bs:
        counts = {k: k.launches for k in route}
        eager, m = eng.train_step(eager, *b)
        _launched(route, counts)
        losses.append(m["loss"])
        local, _ = local_eng.train_step(local, *b)
    scanned, ms = build_parallel_scan(eng, nccl_mesh)(scanned, *(torch.stack([x[i] for x in bs]) for i in range(3)))
    assert torch.equal(ms["losses"], torch.stack(losses)) and int(ms["overflow"]) == 0
    _, evaluate = build_parallel_steps(eng, nccl_mesh)
    es = local_eng.jit_eval_step()
    auc_s, auc_l = auc_init(device=cuda), auc_init(device=cuda)
    for b in _card_batches(schema, 3, cuda, seed=8):
        evaluate(eager, auc_s, *b)
        es(local, auc_l, *b)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(auc_s, auc_l))
    _, low, _ = _sharded_twin("slice2", nccl_mesh, 0.05)
    _, low_cpu, _ = _sharded_twin("slice2", make_mesh(1, group=dist.new_group(backend="gloo")), 0.05)
    ids = bs[0][1]
    got, overflow = low.tables.gather_with_stats(eager.emb_params, low._group_ids(ids))
    want, overflow_cpu = low_cpu.tables.gather_with_stats(_to_cpu(eager.emb_params), low_cpu._group_ids(ids.cpu()))
    assert int(overflow) == int(overflow_cpu) > 0
    assert torch.equal(got["emb"]["d17"].cpu(), want["emb"]["d17"])


@pytest.mark.parametrize("dim", [17, 16, 1])
@pytest.mark.parametrize("opt", ["adagrad", "adam"])
def test_sorted_updates_skip_a_sentinel_tail(cuda, dim, opt):
    """#4 and #7 on an owner's stream: the sorted ids, then a tail of the
    sentinel R (and of INT32_MAX), update the table as the stream without
    the tail, bit for bit, and as their plain versions."""
    g = _gen(cuda, 23)
    rows, n, tail = 3000, 5000, 1300
    shape = (rows,) if dim == 1 else (rows, dim)
    ids = torch.sort(torch.randint(0, rows, (n,), generator=g, device=cuda, dtype=torch.int32))[0]
    sentinels = torch.full((tail,), rows, dtype=torch.int32, device=cuda)
    sentinels[-7:] = torch.iinfo(torch.int32).max
    grads = (torch.randn((n + tail, *shape[1:]), generator=g, device=cuda) * 0.01).to(torch.bfloat16)
    table = torch.randn(shape, generator=g, device=cuda) * 0.05
    state = [torch.rand(shape, generator=g, device=cuda) * 1e-3 + (0.1 if opt == "adagrad" else 0.0)
             for _ in range(1 if opt == "adagrad" else 2)]
    lr = torch.tensor(1e-2, device=cuda)
    scalars = adam_scalars(lr, torch.tensor(4, dtype=torch.int32, device=cuda), 0.9, 0.999)

    def run(kernel, stream, gr, device):
        t, st = table.to(device, copy=True), [s.to(device, copy=True) for s in state]
        if opt == "adagrad":
            kernel(t, st[0], stream.to(device), gr.to(device), lr.to(device), 1e-8)
        else:
            kernel(t, *st, stream.to(device), gr.to(device), scalars.to(device), 0.9, 0.999, 1e-8)
        return [t.cpu(), *(s.cpu() for s in st)]

    kernel = sorted_adagrad_update if opt == "adagrad" else sorted_adam_update
    plain = sorted_adagrad_update_reference if opt == "adagrad" else sorted_adam_update_reference
    with_tail = run(kernel, torch.cat([ids, sentinels]), grads, cuda)
    without = run(kernel, ids, grads[:n], cuda)
    cpu = run(plain, torch.cat([ids, sentinels]), grads, "cpu")
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(with_tail, without))
    assert all(torch.equal(a, b) for a, b in zip(with_tail, cpu))


def test_dense_adam_drops_sentinels_on_the_card(cuda):
    """Dense Adam on an owner's stream with a sentinel tail runs without an
    out-of-range index and equals the update of the stream without the
    tail bit for bit, twice."""
    from recmodels_tpu_torch.embedding.optim import apply_sorted_updates, dense_adam

    g = _gen(cuda, 29)
    rows, n, tail, dim = 4096, 6000, 900, 16
    ids = torch.sort(torch.randint(0, rows, (n,), generator=g, device=cuda, dtype=torch.int32))[0]
    stream = torch.cat([ids, torch.full((tail,), rows, dtype=torch.int32, device=cuda)])
    grads = (torch.randn((n + tail, dim), generator=g, device=cuda) * 0.01).to(torch.bfloat16)
    table = torch.randn((rows, dim), generator=g, device=cuda) * 0.05
    opt = dense_adam()

    def run(s, gr):
        t, st = table.clone(), opt.init(rows, dim, cuda)
        apply_sorted_updates(opt, t, st, s, gr, torch.tensor(2, dtype=torch.int32, device=cuda),
                             torch.tensor(1e-2, device=cuda))
        return [t, st["m"], st["v"]]

    a, b, c = run(stream, grads), run(stream, grads), run(ids, grads[:n])
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) and torch.equal(x, z) for x, y, z in zip(a, b, c))


def test_dense_adam_on_the_card_matches_the_cpu(cuda):
    """Dense Adam (``"adam_dense"``: PyTorch ops, as the JAX package's XLA
    route) on a 4,096 x 16 table from 512 x 26 ids with duplicates: twice
    on the card from one state, bit for bit, with the card's inputs as drawn
    afterwards; its duplicate sums (``index_put_`` with accumulate) within
    f32 rounding of the CPU's (the card adds a row's duplicates in an order
    of its own, so a sum may land an ulp apart); its moments against the
    same update on the CPU from a host copy of the inputs, and its table
    against the Adam step of the CPU's moments in the update's order of
    operations with the root taken in f64 and rounded to f32 (the card's
    f32 root is correctly rounded; the CPU's f32 ``torch.sqrt`` is not, and
    has been seen to compute one thread's share of a tensor 3e-4 apart),
    each within 1e-5 of the tensor's largest change (an ulp of a sum moves
    an element by about 1e-8 of a change here); the untouched rows move
    (the moments decay on every row)."""
    from recmodels_tpu_torch.embedding.optim import apply_updates, get_sparse_optimizer
    from recmodels_tpu_torch.embedding.update import bias_corrections

    g = _gen(cuda, 41)
    rows, dim = 4096, 16
    ids = torch.randint(0, rows, (512, 26), generator=g, device=cuda, dtype=torch.int32)
    m0 = torch.randn((rows, dim), generator=g, device=cuda) * 1e-3
    start = [torch.randn((rows, dim), generator=g, device=cuda) * 0.05, m0, m0 * m0 * 10.0 + 1e-10]
    grads = (torch.randn((ids.numel(), dim), generator=g, device=cuda) * 0.01).to(torch.bfloat16)
    host = [x.cpu() for x in (ids, grads, *start)]
    opt = get_sparse_optimizer("adam_dense")
    step, lr = 30, 1e-2

    def run(ids, grads, start):
        device = ids.device
        t, m, v = (x.to(device, copy=True) for x in start)
        apply_updates(opt, t, {"m": m, "v": v}, ids, grads,
                      torch.tensor(step, dtype=torch.int32, device=device), torch.tensor(lr, device=device))
        return [x.cpu() for x in (t, m, v)]

    def duplicate_sums(ids, grads):
        acc = torch.zeros((rows, dim), device=ids.device)
        acc.index_put_((ids.reshape(-1).long(),), grads.float(), accumulate=True)
        return acc.cpu()

    first, second = run(ids, grads, start), run(ids, grads, start)
    sums = duplicate_sums(ids, grads)
    assert all(torch.equal(x.cpu(), h) for x, h in zip((ids, grads, *start), host)), "the card's inputs changed"
    _, m, v = run(host[0], host[1], host[2:])
    cpu_sums = duplicate_sums(host[0], host[1])
    magnitudes = torch.zeros((rows, dim)).index_put_((host[0].reshape(-1).long(),), host[1].float().abs(),
                                                     accumulate=True)
    assert (sums - cpu_sums).abs().max().item() <= 2.0 ** -20 * magnitudes.max().item()
    h = opt.hyper
    bc1, bc2 = bias_corrections(torch.tensor((h["b1"], h["b2"])), torch.tensor(step + 1, dtype=torch.int32))
    table = host[2] - torch.tensor(lr) * (m / bc1) / (torch.sqrt((v / bc2).double()).float() + h["eps"])
    untouched = torch.ones(rows, dtype=torch.bool)
    untouched[host[0].reshape(-1).long()] = False
    assert int(untouched.sum()) > 0
    for name, got, again, want, old in zip(("table", "m", "v"), first, second, (table, m, v), host[2:]):
        assert torch.equal(got, again)
        err = (got - want).abs()
        r, c = divmod(int(err.argmax()), dim)
        assert err.max().item() <= 1e-5 * (want - old).abs().max().item(), (
            f"{name} at {(r, c)}: card {got[r, c].item()!r}, CPU {want[r, c].item()!r}, start {old[r, c].item()!r}; "
            f"duplicate sums there: card {sums[r, c].item()!r}, CPU {cpu_sums[r, c].item()!r}")
        assert not torch.equal(got[untouched], old[untouched])


# ------------------- checkpoints of sharded states, export, the graft entry
def _fm700(mesh=None):
    """FM at vocab 700 a slot, dim 8: 18,200 rows, allocated 18,432; a
    world of 4 pads them to 20,480 (at world 1 the sharded and the local
    tables have one shape for any vocab: alloc_rows is a multiple of 1,024)."""
    from recmodels_tpu_torch.models import build_model
    from recmodels_tpu_torch.parallel import build_parallel_engine
    from recmodels_tpu_torch.train.engine import Engine
    from recmodels_tpu_torch.utils.config import TrainConfig, build_schema

    schema = build_schema(TrainConfig(model="fm", vocab_size=700, embed_dim=8))
    model = build_model("fm", schema)
    eng = Engine(model, emb_lr=5e-2) if mesh is None else build_parallel_engine(model, mesh, emb_lr=5e-2)
    return eng, schema


def test_gather_state_equals_the_unsharded_state_on_the_card(cuda, nccl_mesh):
    """Two sharded steps, then ``gather_state``: every tensor the local
    engine's after the same steps, the tables new tensors on the card."""
    from recmodels_tpu_torch.parallel import gather_state, shard_state

    local_eng, eng, schema = _sharded_twin("slice2", nccl_mesh)
    start = eng.init(seed=0, device=cuda)
    local, state = shard_state(start, nccl_mesh), shard_state(start, nccl_mesh)
    for b in _card_batches(schema, 2, cuda):
        local, _ = local_eng.train_step(local, *b)
        state, _ = eng.train_step(state, *b)
    glob = gather_state(state, nccl_mesh)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(_tensors(glob), _tensors(local)))
    table = glob.emb_params["emb"]["d17"]
    assert table.is_cuda and table.data_ptr() != state.emb_params["emb"]["d17"].data_ptr()


def test_sharded_checkpoint_round_trip_on_the_card(cuda, nccl_mesh, tmp_path):
    """A manager with the NCCL mesh saves the gathered state and restores
    it into another state's own tensors bit for bit; the restored state's
    next captured step equals the saved state's next eager step."""
    from recmodels_tpu_torch.parallel import build_parallel_steps, shard_state
    from recmodels_tpu_torch.train.checkpoint import CheckpointManager

    _, eng, schema = _sharded_twin("slice3", nccl_mesh)
    state = shard_state(eng.init(seed=0, device=cuda), nccl_mesh)
    b1, b2 = _card_batches(schema, 2, cuda)
    state, _ = eng.train_step(state, *b1)
    mgr = CheckpointManager(str(tmp_path), mesh=nccl_mesh)
    assert mgr.save(1, state, {"step": 1})
    mgr.wait()
    target = shard_state(eng.init(seed=4, device=cuda), nccl_mesh)
    ptrs = [t.data_ptr() for t in _tensors(target)]
    restored, data = mgr.restore(target)
    assert data == {"step": 1} and [t.data_ptr() for t in _tensors(restored)] == ptrs
    assert all(torch.equal(a, b) for a, b in zip(_tensors(restored), _tensors(state)))
    train, _ = build_parallel_steps(eng, nccl_mesh)
    state, m1 = eng.train_step(state, *b2)
    restored, m2 = train(restored, *b2)
    torch.cuda.synchronize()
    assert torch.equal(m1["loss"], m2["loss"])
    assert all(torch.equal(a, b) for a, b in zip(_tensors(restored), _tensors(state)))


def test_cross_geometry_restore_on_the_card(cuda, nccl_mesh, tmp_path):
    """local -> the world-1 sharded engine, a world-4 checkpoint (20,480
    padded rows) -> the world-1 sharded engine (18,432), and that engine's
    gathered save -> local: each restore is the local state bit for bit,
    and the sharded logits the local ones."""
    from recmodels_tpu_torch.parallel import shard_state
    from recmodels_tpu_torch.train.checkpoint import CheckpointManager

    local_eng, schema = _fm700()
    eng, _ = _fm700(nccl_mesh)
    local = local_eng.init(seed=0, device=cuda)
    batches = _card_batches(schema, 3, cuda)
    for b in batches[:2]:
        local, _ = local_eng.train_step(local, *b)
    dense, ids, _ = batches[2]
    want = local_eng.logits(local, dense, ids)
    saver = CheckpointManager(str(tmp_path / "local"))
    saver.save(2, local, {"step": 2})
    saver.wait()

    def pad(t):  # the global padded state of a world of 4
        return torch.cat([t, t.new_zeros((20_480 - t.shape[0], *t.shape[1:]))])

    cpu = local._replace(**{f: {c: {g: (pad(v.cpu()) if isinstance(v, torch.Tensor) else
                                        {k: pad(x.cpu()) for k, x in v.items()}) for g, v in groups.items()}
                                for c, groups in getattr(local, f).items()} for f in ("emb_params", "emb_opt")})
    world4 = CheckpointManager(str(tmp_path / "world4"))
    world4.save(2, cpu, {"step": 2})
    world4.wait()
    for src in ("local", "world4"):
        target = shard_state(eng.init(seed=5, device=cuda), nccl_mesh)
        mgr = CheckpointManager(str(tmp_path / src), mesh=nccl_mesh)
        got, data = mgr.restore_cross_geometry(target)
        assert data == {"step": 2} and got.emb_params["emb"]["d9"].shape[0] == 18_432
        assert all(torch.equal(a, b) for a, b in zip(_tensors(got), _tensors(local))), src
        assert torch.equal(eng.logits(got, dense, ids), want), src
    mgr = CheckpointManager(str(tmp_path / "sharded"), mesh=nccl_mesh)
    mgr.save(2, got, {"step": 2})
    mgr.wait()
    back, _ = CheckpointManager(str(tmp_path / "sharded")).restore_cross_geometry(local_eng.init(seed=6, device=cuda))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(_tensors(back), _tensors(local)))


def test_export_of_a_sharded_state_on_the_card(cuda, nccl_mesh, tmp_path):
    """The artifact exported from the sharded flagship's state after two
    steps in the NCCL world of one is, byte for byte, the artifact of its
    gathered state exported by the local engine."""
    from recmodels_tpu_torch.parallel import gather_state, shard_state
    from recmodels_tpu_torch.serve import export_model

    local_eng, eng, schema = _sharded_twin("slice2", nccl_mesh)
    cfg = _small_engine("slice2")[2]
    state = shard_state(eng.init(seed=0, device=cuda), nccl_mesh)
    for b in _card_batches(schema, 2, cuda):
        state, _ = eng.train_step(state, *b)
    export_model(str(tmp_path / "sharded"), cfg, eng, state)
    export_model(str(tmp_path / "local"), cfg, local_eng, gather_state(state, nccl_mesh))
    for name in ("params.npz", "model.json"):
        assert (tmp_path / "sharded" / name).read_bytes() == (tmp_path / "local" / name).read_bytes()


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_cpu(v) for v in tree]
    return tree.cpu() if isinstance(tree, torch.Tensor) else tree


def test_graft_entry_on_the_card(cuda):
    """``entry()`` on the card: its forward runs the gather and the fused
    CIN kernels and gives finite logits that the CPU's plain path, from the
    same seed and batch, matches within the bf16 tolerance."""
    import graft_entry_torch

    forward, args = graft_entry_torch.entry()
    gathers, cins = gather_rows.launches, K.cin2_forward.launches
    with torch.no_grad():
        got = forward(*args)
    torch.cuda.synchronize()
    assert gather_rows.launches > gathers and K.cin2_forward.launches > cins
    assert got.shape == (256,) and bool(torch.isfinite(got).all())
    state, dense, ids = args  # the card's state (its generator's draws), on the CPU's plain path
    cpu = type(state)(*(_to_cpu(x) for x in state))
    with torch.no_grad():
        want = forward(cpu, dense.cpu(), ids.cpu())
    assert (got.cpu() - want).abs().max() <= BF16_REL_TOL * want.abs().max()


def test_graft_dryrun_on_the_card(cuda):
    """``dryrun_multichip(1)``: one rank in an NCCL world of its own, a
    process of its own, trains a sharded step to a finite loss."""
    import graft_entry_torch

    graft_entry_torch.dryrun_multichip(1)


# ------------------------------------------------------------ pooled bags
# MLPerf Training DLRM-DCNv2's --multi_hot_sizes: 214 ids in 26 bags
MLPERF_HOTNESS = (3, 2, 1, 2, 6, 1, 1, 1, 1, 7, 3, 8, 1, 6, 9, 5, 1, 1, 1, 12, 100, 27, 10, 3, 1, 1)


@pytest.mark.parametrize("hotness,d,b", [
    (MLPERF_HOTNESS, 128, 1000), (MLPERF_HOTNESS, 16, 1000), (MLPERF_HOTNESS, 128, 16_384),
    ((3, 1, 7, 2), 17, 333),     # no multiple of 4: a column a lane
    ((40, 33, 1), 260, 65),      # bags past 32 ids, rows past a warp's 128 columns
    ((1,), 128, 1), ((2, 2), 128, 0),
])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_bag_gather_kernel_is_bit_exact(cuda, hotness, d, b, out_dtype):
    """Against the plain version on the card and on the CPU: both sum each
    bag's f32 rows in bag order with plain f32 additions, so they agree bit
    for bit; a second call repeats the bits. Ids repeat within bags."""
    g = _gen(cuda, 23)
    rows = 300_007
    table = torch.randn((rows, d), generator=g, device=cuda)
    ids = torch.randint(0, rows, (b, sum(hotness)), generator=g, device=cuda, dtype=torch.int32)
    if b and sum(hotness) > 2:
        ids[:, 2] = ids[:, 0]
        ids[0, 0] = rows - 1
    before = bag_gather.launches
    got = bag_gather(table, ids, hotness, out_dtype)
    torch.cuda.synchronize()
    assert bag_gather.launches == before + 1
    assert got.shape == (b, len(hotness), d) and got.dtype == out_dtype
    assert torch.equal(got, bag_gather_reference(table, ids, hotness, out_dtype))
    if b <= 1000:
        assert torch.equal(got.cpu(), bag_gather_reference(table.cpu(), ids.cpu(), hotness, out_dtype))
    assert torch.equal(bag_gather(table, ids, hotness, out_dtype), got)


def test_bag_gather_kernel_on_a_table_off_16_bytes(cuda):
    """A table whose base is off 16 bytes takes the kernel's column-a-lane
    route, with the same bits."""
    g = _gen(cuda, 29)
    table = _off16(torch.randn((5000, 128), generator=g, device=cuda), 4)
    ids = torch.randint(0, 5000, (100, 12), generator=g, device=cuda, dtype=torch.int32)
    got = bag_gather(table, ids, (3, 9), torch.bfloat16)
    assert torch.equal(got, bag_gather_reference(table, ids, (3, 9), torch.bfloat16))


def test_table_past_2_31_elements_is_gathered_and_updated_right(cuda):
    """17 M rows x 128 (2.18e9 elements, past int32): the last rows pooled
    by the bag gather, gathered by the row gather and updated by #4 against
    their plain versions on a copy of those rows alone."""
    rows, d, tail = 17_000_000, 128, 4096
    g = _gen(cuda, 31)
    table = torch.empty((rows, d), device=cuda)
    table[-tail:].normal_(generator=g)
    acc = torch.full((rows, d), 0.1, device=cuda)
    ids = torch.randint(rows - tail, rows, (512, 10), generator=g, device=cuda, dtype=torch.int32)
    ids[0, 0] = rows - 1
    sub = table[-tail:].clone()
    local = ids - (rows - tail)
    assert torch.equal(bag_gather(table, ids, (4, 6), torch.float32),
                       bag_gather_reference(sub, local, (4, 6), torch.float32))
    assert torch.equal(gather_rows(table, ids, torch.float32), gather_rows_reference(sub, local, torch.float32))
    sorted_ids = torch.sort(ids.reshape(-1)).values
    grads = torch.randn((sorted_ids.numel(), d), generator=g, device=cuda).to(torch.bfloat16)
    lr = torch.tensor(0.05, device=cuda)
    sub_acc = acc[-tail:].clone()
    sorted_adagrad_update_reference(sub, sub_acc, sorted_ids - (rows - tail), grads, lr, 1e-8)
    sorted_adagrad_update(table, acc, sorted_ids, grads, lr, 1e-8)
    torch.cuda.synchronize()
    assert torch.equal(table[-tail:], sub) and torch.equal(acc[-tail:], sub_acc)


# Pooled grads read through an index by #4 and #7: MLPerf's hotness at
# 6,400 examples (slot 5's 3 rows take runs of over 2,000 positions, slot
# 20's bags 100 ids), runs from a tile's last lane (position 31) that end
# inside the staged bags (33), one past them (34) or past the next tile
# (65), a run of 2,000 from position 95, and pooled grads off 16 bytes
# (the kernel's column-a-lane route).
_POOLED_CASES = [("mlperf",), ("run", 31, 33), ("run", 31, 34), ("run", 31, 65), ("run", 95, 2000), ("offset",)]


def _pooled_stream(cuda, case, dim, grad_dtype):
    """(table, acc, sorted ids, pooled grads [P, dim] or [P], grad index
    [N] int32) for one of ``_POOLED_CASES``."""
    g = _gen(cuda, 37)
    if case[0] == "mlperf":
        b, hot = 6400, MLPERF_HOTNESS
        vocab = [3 if s == 5 else 4 if s == 16 else 3000 for s in range(len(hot))]
        first = [sum(vocab[:s]) for s in range(len(hot))]
        cols = [s for s, h in enumerate(hot) for _ in range(h)]
        ids_2d = torch.stack([torch.randint(0, vocab[s], (b,), generator=g, device=cuda) + first[s] for s in cols],
                             dim=1).int()
        ids, index = bag_sorted_ids(ids_2d, hot)
        rows, p = sum(vocab), b * len(hot)
        assert int(torch.unique_consecutive(ids, return_counts=True)[1].max()) >= 2000
    else:
        rows, n, p = 5000, 4000 if case[0] == "run" else 3001, 1000
        layout = case if case[0] == "run" else None
        _, _, ids, _ = _stream(cuda, rows, dim, n, 0.3 if layout is None else 0.0, grad_dtype, layout=layout)
        index = torch.randint(0, p, (n,), generator=g, device=cuda, dtype=torch.int32)
    shape = (rows,) if dim == 1 else (rows, dim)
    table = torch.randn(shape, generator=g, device=cuda)
    acc = torch.rand(shape, generator=g, device=cuda) + 0.1
    pooled = torch.randn((p, *shape[1:]), generator=g, device=cuda).to(grad_dtype)
    if case[0] == "offset":
        pooled = _off16(pooled, 4)
    return table, acc, ids, pooled, index


def _sorted_update(opt, fn, arrays, ids, grads, scalars, grad_index=None):
    """``fn`` (a sorted update of ``opt``, kernel or plain) on ``arrays``:
    the table and acc, or the table, m and v."""
    if opt == "adagrad":
        fn(*arrays, ids, grads, scalars, 1e-8, grad_index)
    else:
        fn(*arrays, ids, grads, scalars, 0.9, 0.999, 1e-8, grad_index)


def _pooled_setup(cuda, opt, case, dim, grad_dtype):
    table, acc, ids, pooled, index = _pooled_stream(cuda, case, dim, grad_dtype)
    lr = torch.tensor(0.05, device=cuda)
    if opt == "adagrad":
        return (table, acc), ids, pooled, index, lr, sorted_adagrad_update, sorted_adagrad_update_reference
    scalars = adam_scalars(lr, torch.tensor(4, dtype=torch.int32, device=cuda), 0.9, 0.999)
    return (table, acc - 0.6, acc * 0.01), ids, pooled, index, scalars, sorted_adam_update, sorted_adam_update_reference


@pytest.mark.parametrize("case", _POOLED_CASES)
@pytest.mark.parametrize("dim", [16, 17, 128])
@pytest.mark.parametrize("grad_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("opt", ["adagrad", "adam"])
def test_pooled_update_kernel_is_bit_exact(cuda, case, dim, grad_dtype, opt):
    """#4 and #7 reading pooled grads through ``grad_index`` against the
    pooled grads expanded along the index and then the stream's kernel, and
    against the plain version on the CPU: the same values summed in the same
    order, so bit for bit; a second call from the same state repeats the
    bits."""
    arrays, ids, pooled, index, scalars, kernel, plain = _pooled_setup(cuda, opt, case, dim, grad_dtype)
    cpu = [t.cpu() for t in arrays]
    _sorted_update(opt, plain, cpu, ids.cpu(), pooled.cpu(), scalars.cpu(), index.cpu())
    expanded = [t.clone() for t in arrays]
    _sorted_update(opt, kernel, expanded, ids, torch.index_select(pooled, 0, index), scalars)
    again = [t.clone() for t in arrays]
    before = kernel.launches
    _sorted_update(opt, kernel, arrays, ids, pooled, scalars, index)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert not torch.equal(arrays[0], again[0])
    assert all(torch.equal(a, b) for a, b in zip(arrays, expanded))
    assert all(torch.equal(a.cpu(), b) for a, b in zip(arrays, cpu))
    _sorted_update(opt, kernel, again, ids, pooled, scalars, index)
    assert all(torch.equal(a, b) for a, b in zip(again, arrays))


@pytest.mark.parametrize("bad,error", [
    ("int64", TypeError), ("short", ValueError), ("2-d", ValueError), ("cpu", ValueError), ("rows", ValueError),
])
@pytest.mark.parametrize("opt", ["adagrad", "adam"])
def test_pooled_update_kernel_refuses_a_wrong_grad_index(cuda, bad, error, opt):
    """A grad index that is not int32 [N] on the table's card, or pooled
    grads whose rows do not fit the table, raise before a launch."""
    arrays, ids, pooled, index, scalars, kernel, _ = _pooled_setup(cuda, opt, ("run", 31, 33), 16,
                                                                   torch.bfloat16)
    index = {"int64": index.long(), "short": index[:-1], "2-d": index[None], "cpu": index.cpu()}.get(bad, index)
    grads = pooled[:, :15].contiguous() if bad == "rows" else pooled
    before, t0 = kernel.launches, arrays[0].clone()
    with pytest.raises(error):
        _sorted_update(opt, kernel, arrays, ids, grads, scalars, index)
    assert kernel.launches == before and torch.equal(arrays[0], t0)


def _dlrm_engine(dtype=torch.bfloat16):
    from recmodels_tpu_torch.data.schema import Schema, slot_spec
    from recmodels_tpu_torch.models import build_model
    from recmodels_tpu_torch.train.engine import Engine

    hot = (3, 1, 7, 2, 12)
    schema = Schema(n_dense=13, slots=tuple(slot_spec(f"c{i}", 2000 + 100 * i, 32, h) for i, h in enumerate(hot)))
    model = build_model("dlrm_dcnv2", schema, bottom=(64, 32), top=(128, 64), n_cross=3, low_rank=32,
                        compute_dtype=dtype)
    return Engine(model, dense_optimizer="adagrad", sparse_optimizer="adagrad", dense_lr=0.005, emb_lr=0.005)


def _dlrm_batches(schema, n, device, batch=512, seed=5):
    g = torch.Generator().manual_seed(seed)
    out = []
    for _ in range(n):
        ids = torch.stack([torch.randint(0, 60, (batch,), generator=g) for _ in schema.id_slots], dim=1).int()
        dense = torch.log1p(torch.rand((batch, schema.n_dense), generator=g) * 50)
        labels = (torch.rand(batch, generator=g) < 0.3).float()
        out.append(tuple(t.to(device) for t in (dense, ids, labels)))
    return out


def test_dlrm_captured_steps_equal_eager_steps(cuda):
    """DLRM-DCNv2 on multi-hot slots: five ``jit_train_step`` steps against
    five eager ones, bit for bit (the bag gather, the one stable sort and #4
    on the pooled grads replay their steps' values); every step launches
    the bag gather and #4 once, and takes the pooled route once."""
    eng = _dlrm_engine()
    eager, captured = eng.init(seed=0, device=cuda), eng.init(seed=0, device=cuda)
    ts = eng.jit_train_step()
    for b in _dlrm_batches(eng.model.schema, 5, cuda):
        bags, updates = bag_gather.launches, sorted_adagrad_update.launches
        pooled = profiling.snapshot()["counters"].get("emb.bag_pooled_updates", 0)
        eager, me = eng.train_step(eager, *b)
        assert (bag_gather.launches - bags, sorted_adagrad_update.launches - updates) == (1, 1)
        assert profiling.snapshot()["counters"]["emb.bag_pooled_updates"] - pooled == 1
        captured, mc = ts(captured, *b)
        assert torch.equal(mc["loss"], me["loss"])
    torch.cuda.synchronize()
    assert ts.graphs == 1
    assert all(torch.equal(a, b) for a, b in zip(_tensors(captured), _tensors(eager)))


def test_dlrm_captured_steps_equal_the_expanded_route(cuda, monkeypatch):
    """Five captured DLRM-DCNv2 steps (#4 reading the pooled grads through
    the sorted bags) against five eager steps of the route before it: the
    pooled grads expanded along the sorted bags by ``index_select``, then
    ``apply_sorted_updates`` on the stream. The table, accumulator and
    every dense leaf bit for bit."""
    from recmodels_tpu_torch.embedding.optim import apply_sorted_updates
    from recmodels_tpu_torch.train import engine as engine_mod

    def expanded_route(opt, table, state, ids_2d, pooled, hotness, step, lr, sorted_stream=None):
        sorted_ids, bags = bag_sorted_ids(ids_2d, hotness) if sorted_stream is None else sorted_stream
        grads = torch.index_select(pooled.reshape(-1, pooled.shape[-1]), 0, bags).reshape(-1, *table.shape[1:])
        return apply_sorted_updates(opt, table, state, sorted_ids, grads, step, lr)

    eng = _dlrm_engine()
    old, captured = eng.init(seed=0, device=cuda), eng.init(seed=0, device=cuda)
    ts = eng.jit_train_step()
    for b in _dlrm_batches(eng.model.schema, 5, cuda, seed=11):
        captured, mc = ts(captured, *b)
        with monkeypatch.context() as m:
            m.setattr(engine_mod, "apply_bag_updates", expanded_route)
            pooled = profiling.snapshot()["counters"].get("emb.bag_pooled_updates", 0)
            old, mo = eng.train_step(old, *b)
            assert profiling.snapshot()["counters"].get("emb.bag_pooled_updates", 0) == pooled
        assert torch.equal(mc["loss"], mo["loss"])
    torch.cuda.synchronize()
    assert ts.graphs == 1
    assert all(torch.equal(a, b) for a, b in zip(_tensors(captured), _tensors(old)))


@pytest.mark.parametrize("path", _STEP_PATHS + ["dlrm"])
def test_step_on_the_card_matches_the_cpu(cuda, path):
    """One training step on the card against the same step on the CPU's
    plain path, from one state. Every path of ``_small_engine`` from a live
    state (``_liven``) at 512 examples: the step launches the kernels of its
    route (``_ROUTES``); the loss within LOGIT_REL_TOL of the largest
    |logit|; Adam's moments and the touched rows of each table and of its
    optimizer state within STEP_REL_TOL of the CPU step's largest change
    (the fused table's embedding columns and first-order column each to its
    own); lazy Adam's table the Adam step of the card's own moments, bit for
    bit; untouched rows bit for bit. DLRM-DCNv2 in f32: the bag sums and #4
    agree bit for bit with their plain versions, the GEMMs sum in other
    orders (f32, no TF32), so the losses and the new state agree to 1e-5 of
    each tensor's largest value."""
    if path != "dlrm":
        _step_matches_the_cpu(cuda, path)
        return
    eng = _dlrm_engine(torch.float32)
    card = eng.init(seed=0, device=cuda)
    cpu = _to_cpu_state(card)
    (b,) = _dlrm_batches(eng.model.schema, 1, cuda)
    _, mc = eng.train_step(card, *b)
    _, mh = eng.train_step(cpu, *(t.cpu() for t in b))
    assert abs(float(mc["loss"]) - float(mh["loss"])) <= 1e-5 * abs(float(mh["loss"]))
    for a, h in zip(_tensors(card), _tensors(cpu)):
        assert float((a.cpu().double() - h.double()).abs().max()) <= 1e-5 * max(float(h.double().abs().max()), 1e-3)


def test_dlrm_predictor_on_the_card(cuda):
    """``Predictor`` on multi-hot ids: each bucket graph's logits equal the
    eager ``Engine.logits`` bit for bit."""
    import numpy as np

    from recmodels_tpu_torch.serve import Predictor

    eng = _dlrm_engine()
    state = eng.init(seed=0, device=cuda)
    (b,) = _dlrm_batches(eng.model.schema, 1, cuda, batch=300)
    pred = Predictor(eng, state, torch.device(cuda))
    got = pred.predict_logits(b[0].cpu().numpy(), b[1].cpu().numpy())
    pad = torch.zeros((212, 13), device=cuda), torch.zeros((212, b[1].shape[1]), dtype=torch.int32, device=cuda)
    with torch.inference_mode():
        want = eng.logits(state, torch.cat([b[0], pad[0]]), torch.cat([b[1], pad[1]]))[:300]
    assert np.array_equal(got, want.cpu().numpy())


# The Wukong FM kernels (csrc/wukong_fm.cu): the cell's layers (n 32, and
# layer 1's 27 rows), the small and ragged, and every template (k 16 or 32,
# n_L up to 16 or 32)
_WUKONG_FM_CASES = {
    "cell": (16384, 32, 128, 32, 16, 16),
    "cell_layer1": (16384, 27, 128, 32, 16, 16),
    "small": (100, 5, 16, 16, 3, 2),
    "wide": (77, 32, 256, 32, 32, 0),
    "ragged": (65, 17, 48, 16, 20, 1),
}


def _wukong_fm_inputs(cuda, b, n, d, k, n_l, n_f, seed=0):
    g = _gen(cuda, seed)
    x = torch.randn((b, n, d), generator=g, device=cuda).to(torch.bfloat16)
    y = (torch.randn((n, k), generator=g, device=cuda) / n ** 0.5).to(torch.bfloat16)
    w = (torch.randn((n, n_l), generator=g, device=cuda) / n ** 0.5).to(torch.bfloat16)
    scale = 1 + 0.1 * torch.randn((n * k,), generator=g, device=cuda)
    shift = 0.1 * torch.randn((n * k,), generator=g, device=cuda)
    g_a = torch.randn((b, n * k), generator=g, device=cuda).to(torch.bfloat16)
    g_s = torch.randn((b, n_f + n_l + 1, d), generator=g, device=cuda).to(torch.bfloat16)
    g_res = torch.randn((b, n, d), generator=g, device=cuda).to(torch.bfloat16)
    return x, y, w, scale, shift, g_a, g_s, g_res


def _rel_norm(got, want):
    return float((got.double() - want.double()).norm() / want.double().norm().clamp(min=1e-30))


@pytest.mark.parametrize("case", sorted(_WUKONG_FM_CASES))
def test_wukong_fm_kernels_match_their_plain_versions(cuda, case):
    """Both FM kernels against their plain versions (``nn/wukong_fm``): the
    bf16 outputs a, l and g_x within BF16_REL_TOL of their largest value (Z
    and g_F round to bf16 after sums in another order, so an element may
    land a bf16 step apart), the LN's mean within 1e-2 of its standard
    deviation and rstd within 1e-2; the f32 weight grads (batch sums of
    terms that carry those roundings) within 1e-2 of the reference's norm,
    g_shift (sums of the same bf16 values in another order) within 1e-5;
    each call launches once and a second backward gives the same bits (no
    atomics)."""
    from recmodels_tpu_torch.nn.wukong_fm import (
        fm_backward, fm_backward_reference, fm_forward, fm_forward_reference,
    )

    b, n, d, k, n_l, n_f = _WUKONG_FM_CASES[case]
    x, y, w, scale, shift, g_a, g_s, g_res = _wukong_fm_inputs(cuda, b, n, d, k, n_l, n_f)
    before = fm_forward.launches, fm_backward.launches
    a, l, mean, rstd = fm_forward(x, y, w, scale, shift)
    want = fm_forward_reference(x, y, w, scale, shift, 1e-5)
    torch.cuda.synchronize()
    for got, ref in ((a, want[0]), (l, want[1])):
        assert got.dtype == torch.bfloat16 and got.shape == ref.shape
        err, top = _max_err(got, ref)
        assert err <= BF16_REL_TOL * top, (case, err, top)
    assert float(((mean - want[2]) * want[3]).abs().max()) <= 1e-2
    assert float((rstd / want[3] - 1).abs().max()) <= 1e-2
    grads = fm_backward(x, y, w, scale, mean, rstd, g_a, g_s, n_f, g_res)
    refs = fm_backward_reference(x, y, w, scale, mean, rstd, g_a, g_s, n_f, g_res)
    torch.cuda.synchronize()
    assert (fm_forward.launches, fm_backward.launches) == (before[0] + 1, before[1] + 1)
    err, top = _max_err(grads[0], refs[0])
    assert grads[0].dtype == torch.bfloat16 and err <= BF16_REL_TOL * top, (case, err, top)
    for got, ref in zip(grads[1:4], refs[1:4]):
        assert got.dtype == torch.float32 and got.shape == ref.shape and _rel_norm(got, ref) <= 1e-2, case
    assert _rel_norm(grads[4], refs[4]) <= 1e-5
    again = fm_backward(x, y, w, scale, mean, rstd, g_a, g_s, n_f, g_res)
    assert all(torch.equal(p, q) for p, q in zip(grads, again))


def _max_err(got, want):
    got, want = got.float(), want.float()
    return float((got - want).abs().max()), float(want.abs().max())


@pytest.mark.parametrize("n,k,n_l,d", [(33, 32, 16, 128), (32, 24, 16, 128), (32, 32, 33, 128), (32, 32, 16, 40)])
def test_wukong_fm_kernels_refuse_shapes_past_their_limits(cuda, n, k, n_l, d):
    from recmodels_tpu_torch.nn.wukong_fm import fm_forward

    x, y, w, scale, shift, *_ = _wukong_fm_inputs(cuda, 8, n, d, k, n_l, 0)
    before = fm_forward.launches
    with pytest.raises(ValueError, match="no kernel"):
        fm_forward(x, y, w, scale, shift)
    assert fm_forward.launches == before


def _wukong_engine(dtype=torch.bfloat16):
    from recmodels_tpu_torch.data.schema import Schema, slot_spec
    from recmodels_tpu_torch.models import build_model
    from recmodels_tpu_torch.train.engine import Engine

    hot = (3, 1, 7, 2, 12)
    schema = Schema(n_dense=13, slots=tuple(slot_spec(f"c{i}", 2000 + 100 * i, 32, h) for i, h in enumerate(hot)))
    model = build_model("wukong", schema, bottom=(64, 32), top=(128, 64), n_layers=3, n_fmb=8, n_lcb=8,
                        fm_rank=16, fmb_hidden=(256,), compute_dtype=dtype)
    return Engine(model, dense_optimizer="adagrad", sparse_optimizer="adagrad", dense_lr=0.005, emb_lr=0.005)


def test_wukong_captured_steps_equal_eager_steps(cuda):
    """Wukong (three layers, the first projecting 6 inputs to 16) on
    multi-hot slots: five ``jit_train_step`` steps against five eager ones,
    bit for bit (the FM kernels' weight grads are fixed-order sums); each
    eager step launches each FM kernel once a layer and adds 3 to
    ``wukong.fm_layers``, the captured steps at their eager first call and
    at capture (the graph and its timed twin), not on replays."""
    from recmodels_tpu_torch.nn.wukong_fm import fm_backward, fm_forward

    eng = _wukong_engine()
    eager, captured = eng.init(seed=0, device=cuda), eng.init(seed=0, device=cuda)
    ts = eng.jit_train_step()
    counter = lambda: profiling.snapshot()["counters"].get("wukong.fm_layers", 0)  # noqa: E731
    before_captured = 0
    for i, b in enumerate(_dlrm_batches(eng.model.schema, 5, cuda, seed=13)):
        launches, layers = (fm_forward.launches, fm_backward.launches), counter()
        eager, me = eng.train_step(eager, *b)
        assert (fm_forward.launches - launches[0], fm_backward.launches - launches[1]) == (3, 3)
        assert counter() - layers == 3
        before_captured = counter()
        captured, mc = ts(captured, *b)
        # the eager first call; the capture of the graph and of its timed twin
        assert counter() - before_captured == {0: 3, 1: 6}.get(i, 0)
        assert torch.equal(mc["loss"], me["loss"])
    torch.cuda.synchronize()
    assert ts.graphs == 1
    assert all(torch.equal(a, b) for a, b in zip(_tensors(captured), _tensors(eager)))


def test_wukong_step_on_the_card_matches_the_cpu(cuda):
    """One bf16 Wukong step on the card (the FM kernels) against the same
    step on the CPU's plain path, from one state: the loss within
    LOGIT_REL_TOL of the largest |logit|; each parameter's change (every
    dense leaf and the table) within STEP_REL_TOL of the CPU step's largest
    change of it (Adagrad's first step moves each element by its grad over
    the root of 0.1 plus its square, so a grad's bf16 rounding flips move it
    alike). The accumulators, which move by the grads' squares and double
    their relative error, are left to the f32 and bit-for-bit tests."""
    eng = _wukong_engine()
    card = eng.init(seed=0, device=cuda)
    cpu = _to_cpu_state(card)

    def params(state):
        from recmodels_tpu_torch.utils.tree import leaves

        return [*leaves(state.dense_params), *state.emb_params["emb"].values()]

    start = [t.cpu().clone() for t in params(card)]
    (b,) = _dlrm_batches(eng.model.schema, 1, cuda, seed=17)
    with torch.no_grad():
        top = float(eng.logits(cpu, *(t.cpu() for t in b[:2])).abs().max())
    _, mc = eng.train_step(card, *b)
    _, mh = eng.train_step(cpu, *(t.cpu() for t in b))
    assert abs(float(mc["loss"]) - float(mh["loss"])) <= LOGIT_REL_TOL * max(top, 1.0)
    for a, h, s in zip(params(card), params(cpu), start):
        da, dh = a.cpu().double() - s.double(), h.double() - s.double()
        assert float((da - dh).abs().max()) <= STEP_REL_TOL * max(float(dh.abs().max()), 1e-12)


def test_wukong_predictor_on_the_card(cuda):
    """``Predictor`` on multi-hot ids through the FM kernels: each bucket
    graph's logits equal the eager ``Engine.logits`` bit for bit."""
    from recmodels_tpu_torch.serve import Predictor

    eng = _wukong_engine()
    state = eng.init(seed=0, device=cuda)
    (b,) = _dlrm_batches(eng.model.schema, 1, cuda, batch=300)
    pred = Predictor(eng, state, torch.device(cuda))
    got = pred.predict_logits(b[0].cpu().numpy(), b[1].cpu().numpy())
    pad = torch.zeros((212, 13), device=cuda), torch.zeros((212, b[1].shape[1]), dtype=torch.int32, device=cuda)
    with torch.inference_mode():
        want = eng.logits(state, torch.cat([b[0], pad[0]]), torch.cat([b[1], pad[1]]))[:300]
    assert np.array_equal(got, want.cpu().numpy())


# The Wukong residual sum and LayerNorm (csrc/wukong_ln.cu): the cell's
# layers (16 FMB and 16 LCB rows of 128), and each width it takes
_WUKONG_LN_CASES = {
    "cell": (16384, 16, 16, 128),
    "d32": (100, 3, 5, 32),
    "d64": (90, 5, 3, 64),
    "d256": (33, 2, 1, 256),
    "fmb_only": (70, 4, 0, 128),
}


@pytest.mark.parametrize("case", sorted(_WUKONG_LN_CASES))
def test_wukong_ln_kernels_match_their_plain_versions(cuda, case):
    """Both LayerNorm kernels against their plain versions (``nn/wukong_ln``):
    s bit for bit (one rounding of the same f32 sum); y and g_s within
    BF16_REL_TOL of their largest value (the row statistics summed in
    another order may move a value a bf16 step), the mean and rstd within
    1e-5; g_h the first n_F rows of g_s bit for bit; the scale's and
    shift's grads (f32 sums over every row in another order) within 1e-4 of
    the plain version's norm; a second backward the same bits."""
    from recmodels_tpu_torch.nn.wukong_ln import (
        residual_ln_backward, residual_ln_backward_reference, residual_ln_forward, residual_ln_forward_reference,
    )

    b, n_f, n_l, d = _WUKONG_LN_CASES[case]
    g = _gen(cuda, 5)
    h = torch.randn((b, n_f * d), generator=g, device=cuda).to(torch.bfloat16)
    l = torch.randn((b, n_l, d), generator=g, device=cuda).to(torch.bfloat16)
    r = torch.randn((b, n_f + n_l, d), generator=g, device=cuda).to(torch.bfloat16)
    scale = 1 + 0.1 * torch.randn((d,), generator=g, device=cuda)
    shift = 0.1 * torch.randn((d,), generator=g, device=cuda)
    cot = torch.randn(r.shape, generator=g, device=cuda).to(torch.bfloat16)
    before = residual_ln_forward.launches, residual_ln_backward.launches
    s, y, mean, rstd = residual_ln_forward(h, l, r, scale, shift)
    want = residual_ln_forward_reference(h, l, r, scale, shift, 1e-5)
    torch.cuda.synchronize()
    assert torch.equal(s, want[0])
    err, top = _max_err(y, want[1])
    assert err <= BF16_REL_TOL * top, (case, err, top)
    assert torch.allclose(mean, want[2], rtol=1e-5, atol=1e-6) and torch.allclose(rstd, want[3], rtol=1e-5)
    grads = residual_ln_backward(cot, s, mean, rstd, scale, n_f)
    refs = residual_ln_backward_reference(cot, s, mean, rstd, scale, n_f)
    torch.cuda.synchronize()
    assert (residual_ln_forward.launches, residual_ln_backward.launches) == (before[0] + 1, before[1] + 1)
    err, top = _max_err(grads[0], refs[0])
    assert err <= BF16_REL_TOL * top, (case, err, top)
    assert torch.equal(grads[1], grads[0][:, :n_f].reshape(b, -1))
    for got, ref in zip(grads[2:], refs[2:]):
        assert got.dtype == torch.float32 and _rel_norm(got, ref) <= 1e-4, case
    again = residual_ln_backward(cot, s, mean, rstd, scale, n_f)
    assert all(torch.equal(p, q) for p, q in zip(grads, again))
