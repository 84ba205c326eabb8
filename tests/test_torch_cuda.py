"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These need an NVIDIA GPU (the kernels have no CPU mode) and skip elsewhere.
The file imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Small and ragged shapes here; ``chip_smoke.py`` covers the flagship shapes.
"""

import pytest
import torch

from recmodels_tpu_torch.embedding.gather import gather_rows, gather_rows_reference
from recmodels_tpu_torch.embedding.update import sorted_adagrad_update, sorted_adagrad_update_reference
from recmodels_tpu_torch.nn.mlp import ProductF32
from recmodels_tpu_torch.ops.cuda import interactions_cuda as K

pytestmark = pytest.mark.cuda

# bf16 results summed in f32 in another order may round one bf16 step apart
# (2^-8 relative); 1% of the largest magnitude covers that with margin
BF16_REL_TOL = 1e-2


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


@pytest.mark.parametrize("b", [1, 17, 300])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_split_fused_rows_kernel(cuda, b, dtype):
    full = torch.randn((b, 26, 17), generator=_gen(cuda), device=cuda).to(dtype)
    before = K.split_fused_rows.launches
    x_dm, ws = K.split_fused_rows(full, 16)
    torch.cuda.synchronize()
    assert K.split_fused_rows.launches == before + 1
    x_ref, ws_ref = K.split_fused_rows_reference(full, 16)
    assert torch.equal(x_dm, x_ref) and ws.shape == (b,)
    torch.testing.assert_close(ws, ws_ref, rtol=1e-5, atol=1e-5)  # f32 sums in another order


@pytest.mark.parametrize("b,d,m,h1,h2", [
    (1, 16, 26, 128, 128),
    (33, 16, 26, 128, 128),  # ragged: 2 full blocks and one example
    (20, 8, 26, 16, 32),
    (5, 3, 7, 48, 16),
])
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


def test_cin_stack_dm_flat_has_no_f32_kernel(cuda):
    x = torch.zeros((2, 16, 26), device=cuda)
    w = [torch.zeros((26, 26 * 16), device=cuda), torch.zeros((16, 26 * 16), device=cuda)]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        K.cin_stack_dm_flat(x, w)


@pytest.mark.parametrize("b", [1, 17, 300])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_split_fused_rows_backward_kernel(cuda, b, dtype):
    g = _gen(cuda, 2)
    g_dm = torch.randn((b, 16, 26), generator=g, device=cuda).to(dtype)
    g_ws = torch.randn((b,), generator=g, device=cuda)
    before = K.split_fused_rows_backward.launches
    got = K.split_fused_rows_backward(g_dm, g_ws)
    torch.cuda.synchronize()
    assert K.split_fused_rows_backward.launches == before + 1
    assert torch.equal(got, K.split_fused_rows_backward_reference(g_dm, g_ws))


def _stream(cuda, rows, dim, n, hot, grad_dtype, seed=3):
    """Sorted ids with a hot id taking ``hot`` of the stream and sentinels
    (ids >= rows) at the tail; the table, acc and grads."""
    g = _gen(cuda, seed)
    ids = torch.randint(0, rows, (n,), generator=g, device=cuda, dtype=torch.int32)
    ids[torch.rand((n,), generator=g, device=cuda) < hot] = rows // 3
    ids = torch.sort(ids).values
    ids[-3:] = torch.tensor([rows, rows, rows + 7], dtype=torch.int32, device=cuda)
    shape = (rows,) if dim == 1 else (rows, dim)
    table = torch.randn(shape, generator=g, device=cuda)
    acc = torch.rand(shape, generator=g, device=cuda) + 0.1
    grads = torch.randn((n, *shape[1:]), generator=g, device=cuda).to(grad_dtype)
    return table, acc, ids, grads


@pytest.mark.parametrize("rows,dim,n,hot", [
    (5000, 17, 5, 0.0),
    (5000, 17, 3001, 0.0),
    (5000, 17, 3001, 0.6),   # a run of ~1,800 duplicates
    (2000, 1, 4000, 0.3),    # a dim-1 table
    (300, 5, 20000, 0.9),    # nearly every position a duplicate
])
@pytest.mark.parametrize("grad_dtype", [torch.bfloat16, torch.float32])
def test_adagrad_update_kernel_is_bit_exact(cuda, rows, dim, n, hot, grad_dtype):
    """Against the plain version on the CPU, which sums each run in stream
    order as the kernel does; every operation rounds the same way, so the
    two agree bit for bit. Rows outside the stream keep their bits."""
    table, acc, ids, grads = _stream(cuda, rows, dim, n, hot, grad_dtype)
    t_cpu, a_cpu = table.cpu(), acc.cpu()
    sorted_adagrad_update_reference(t_cpu, a_cpu, ids.cpu(), grads.cpu(), 0.05, 1e-8)
    t0 = table.clone()
    before = sorted_adagrad_update.launches
    sorted_adagrad_update(table, acc, ids, grads, 0.05, 1e-8)
    torch.cuda.synchronize()
    assert sorted_adagrad_update.launches == before + 1
    assert torch.equal(table.cpu(), t_cpu) and torch.equal(acc.cpu(), a_cpu)
    touched = torch.zeros(rows, dtype=torch.bool, device=cuda)
    touched[ids[ids < rows].long()] = True
    assert torch.equal(table[~touched], t0[~touched])


@pytest.mark.parametrize("b,d,m,h1,h2", [
    (1, 16, 26, 128, 128),
    (33, 16, 26, 128, 128),  # ragged: 2 full blocks and one example
    (1100, 16, 26, 128, 128),  # two gw2 slices
    (20, 8, 26, 16, 32),
    (5, 3, 7, 48, 16),
])
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
