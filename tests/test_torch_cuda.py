"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These need an NVIDIA GPU (the kernels have no CPU mode) and skip elsewhere.
The file imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Small and ragged shapes here; ``chip_smoke.py`` covers the flagship shapes.
"""

import pytest
import torch

from recmodels_tpu_torch.embedding.gather import gather_rows, gather_rows_reference
from recmodels_tpu_torch.embedding.update import (
    adam_scalars, sorted_adagrad_update, sorted_adagrad_update_reference, sorted_adam_update,
    sorted_adam_update_reference,
)
from recmodels_tpu_torch.nn.mlp import ProductF32
from recmodels_tpu_torch.ops.cuda import build
from recmodels_tpu_torch.ops.cuda import interactions_cuda as K

pytestmark = pytest.mark.cuda

# bf16 results summed in f32 in another order may round one bf16 step apart
# (2^-8 relative); 1% of the largest magnitude covers that with margin
BF16_REL_TOL = 1e-2
# f32 CIN layer: the same f32 sums (up to Hk * m terms) in another order
F32_REL_TOL = 1e-4


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


@pytest.mark.parametrize("d,hs", [(32, (128, 128)), (32, (256, 256)), (16, (100, 100)), (32, (100, 100))])
def test_two_layer_bf16_cin_on_the_card_matches_the_cpu(cuda, d, hs):
    """``cin_stack_dm_flat`` on the card against the same call on the CPU
    (the plain versions of the same route): d = 32 with CIN(128,128) and
    CIN(256,256) take the fused kernels, CIN(100,100) goes layer by layer.
    Pools by 1% of the largest, grads by the repo's bf16 rule (3%)."""
    g = _gen(cuda, 17)
    b, m = 40, 26
    h1, h2 = hs
    x = torch.randn((b, d, m), generator=g, device=cuda).to(torch.bfloat16)
    w1 = (torch.randn((m, m * h1), generator=g, device=cuda) * (2.0 / (m * m)) ** 0.5).to(torch.bfloat16)
    w2 = (torch.randn((h1, m * h2), generator=g, device=cuda) * (2.0 / (h1 * m)) ** 0.5).to(torch.bfloat16)
    cot = torch.randn((b, h1 + h2), generator=g, device=cuda).to(torch.bfloat16)
    fused = K.cin2_takes(d, m, h1, h2, torch.bfloat16)
    assert fused is (hs != (100, 100))
    outs = []
    for dev in (cuda, torch.device("cpu")):
        ins = [t.to(dev).clone().requires_grad_(True) for t in (x, w1, w2)]
        counts = (K.cin2_forward.launches, K.cin2_backward.launches, K.cin_layer_forward.launches)
        pools = K.cin_stack_dm_flat(ins[0], ins[1:])
        grads = torch.autograd.grad((pools.float() * cot.to(dev).float()).sum(), ins)
        torch.cuda.synchronize()
        launched = (K.cin2_forward.launches - counts[0], K.cin2_backward.launches - counts[1],
                    K.cin_layer_forward.launches - counts[2])
        if dev.type == "cuda":
            assert launched == ((1, 1, 0) if fused else (0, 0, 2))
        outs.append([pools, *grads])
    for got, want, frac in zip(outs[0], outs[1], (BF16_REL_TOL, 0.03, 0.03, 0.03)):
        assert got.dtype == torch.bfloat16 and got.shape == want.shape
        err = (got.detach().float().cpu() - want.detach().float()).abs().max().item()
        assert err <= frac * want.detach().float().abs().max().item()


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
def _small_engine(path):
    """Small engines of every training path: slice 2 (CIN(32, 32), fused
    wide column, Adagrad), slice 3 (CIN(128, 128, 128), unfused wide table,
    lazy Adam), DeepFM, DCN and FM (slice 4), LR, PNN (mode both), Wide&Deep,
    NFM and AFM (slice 6), bench.py's dtypes."""
    from recmodels_tpu_torch.models import build_model
    from recmodels_tpu_torch.train.engine import Engine
    from recmodels_tpu_torch.utils.config import TrainConfig, build_schema

    model = "xdeepfm" if path.startswith("slice") else path
    kw = {"slice2": dict(cin_sizes=(32, 32)), "slice3": dict(cin_sizes=(128, 128, 128)),
          "dcn": dict(n_cross=2), "afm": dict(attention_dim=8)}.get(path, {})
    cfg = TrainConfig(model=model, vocab_size=1000, embed_dim=16, hidden=(64, 64),
                      bf16=path not in ("fm", "lr"), **kw)
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
    tolerance (1% of the largest |logit|, as chip_smoke.py) of the unpadded
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
