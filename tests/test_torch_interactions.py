"""The port's interaction ops on the CPU against the JAX package.

* plain ops (``ops/interactions.py``) against ``recmodels_tpu.ops.interactions``;
* ``split_fused_rows_reference`` against JAX's ``split_fused_rows``;
* ``cin2_forward_reference`` (the fused CIN kernel's plain version, in the
  kernel's pair-pool form) against JAX's ``cin_stack_dm_flat`` in f32 and,
  in bf16, against the f32 einsum oracle. JAX has no CPU path for its fused
  CIN kernel (``_cin2_supported`` is false in interpret mode), so the oracle
  stands in for it;
* the backward: ``cin2_backward_reference`` against ``jax.vjp`` of JAX's
  ``cin_stack_dm_flat`` (f32 tightly; bf16 by the repo's rule against the
  f32 grads), ``split_fused_rows_backward_reference`` against ``jax.vjp`` of
  JAX's ``split_fused_rows`` exactly, and the ``autograd.Function``s
  (``Cin2``, ``SplitFusedRows``, the MLP's ``ProductF32``) against
  ``torch.autograd`` through the plain ops;
* dispatch: what runs for a CPU tensor and what raises for other devices.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recmodels_tpu.ops import dispatch as jdispatch
from recmodels_tpu.ops import interactions as J
from recmodels_tpu_torch.nn.mlp import ProductF32
from recmodels_tpu_torch.ops import interactions as T
from recmodels_tpu_torch.ops.cuda import interactions_cuda as K
from recmodels_tpu_torch.ops.dispatch import get_op

F32_TOL = 1e-4  # f32 CIN: the same sums in another order and association


def _close_rule(got, want, frac: float = 0.03) -> None:
    """bf16 against the f32 oracle, the rule of tests/test_tpu_kernels.py:
    max |err| <= frac * max |ref| + 1e-3 (bf16 rounds x1, Q and the pools)."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert np.max(np.abs(got - want)) <= frac * np.max(np.abs(want)) + 1e-3


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


@pytest.fixture
def cin_inputs():
    def make(b, d, m, h1, h2, seed=0):
        rng = np.random.default_rng(seed)
        x_dm = rng.normal(size=(b, d, m)).astype(np.float32)
        w1 = (rng.normal(size=(m, m * h1)) * np.sqrt(2.0 / (m * m))).astype(np.float32)
        w2 = (rng.normal(size=(h1, m * h2)) * np.sqrt(2.0 / (h1 * m))).astype(np.float32)
        return x_dm, w1, w2
    return make


def _oracle(x_dm, w1, w2):
    """f32 einsum oracle (numpy, f64 accumulation): x1, p1, p2 and Q."""
    b, d, m = x_dm.shape
    h1 = w1.shape[1] // m
    h2 = w2.shape[1] // m
    x0 = x_dm.reshape(b * d, m).astype(np.float64)
    x1 = np.einsum("rh,hin,ri->rn", x0, w1.reshape(m, m, h1).astype(np.float64), x0)
    x2 = np.einsum("rh,hin,ri->rn", x1, w2.reshape(h1, m, h2).astype(np.float64), x0)
    q = np.einsum("bdj,bdk->bjk", x0.reshape(b, d, m), x1.reshape(b, d, h1)).reshape(b, m * h1)
    return x1, x1.reshape(b, d, h1).sum(1), x2.reshape(b, d, h2).sum(1), q


# ------------------------------------------------------------- plain ops
def test_flatten_unflatten_match_jax():
    w = np.random.default_rng(0).normal(size=(6, 5, 4)).astype(np.float32)
    flat = T.flatten_cin_w(torch.from_numpy(w))
    np.testing.assert_array_equal(flat.numpy(), np.asarray(J.flatten_cin_w(jnp.asarray(w))))
    np.testing.assert_array_equal(T.unflatten_cin_w(flat, 4).numpy(), w)


@pytest.mark.parametrize("op", ["cin_stack", "cin_stack_dm", "cin_stack_flat", "cin_stack_dm_flat"])
def test_cin_stacks_match_jax_f32(op):
    rng = np.random.default_rng(1)
    b, m, d, hs = 8, 5, 4, (6, 7, 3)
    x = rng.normal(size=(b, m, d)).astype(np.float32)
    ws, h = [], m
    for hn in hs:
        ws.append(rng.normal(size=(hn, h, m)).astype(np.float32) * 0.3)
        h = hn
    if op.endswith("_dm") or op.endswith("_dm_flat"):
        x = np.ascontiguousarray(np.swapaxes(x, 1, 2))
    if op.endswith("_flat"):
        ws = [np.array(J.flatten_cin_w(jnp.asarray(w))) for w in ws]
    want = np.asarray(getattr(J, op)(jnp.asarray(x), [jnp.asarray(w) for w in ws]))
    got = getattr(T, op)(torch.from_numpy(x), [torch.from_numpy(w) for w in ws])
    np.testing.assert_allclose(got.numpy(), want, rtol=F32_TOL, atol=F32_TOL)


def test_cin_layer_matches_jax_bf16():
    rng = np.random.default_rng(2)
    xk, x0 = rng.normal(size=(4, 6, 8)), rng.normal(size=(4, 5, 8))
    w = rng.normal(size=(7, 6, 5)) * 0.2
    jx = [jnp.asarray(a, jnp.bfloat16) for a in (xk, x0, w)]
    tx = [torch.tensor(np.asarray(a.astype(jnp.float32))).to(torch.bfloat16) for a in jx]
    want = np.asarray(J.cin_layer(*jx).astype(jnp.float32))
    got = _np(T.cin_layer(*tx))
    # same bf16 inputs, f32 sums in another order, one bf16 rounding: 1 ulp
    np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=1e-6)


# ---------------------------------------------------- fused-row fanout
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_split_fused_rows_reference_matches_jax(dtype):
    rng = np.random.default_rng(3)
    b, m, d = 37, 26, 8
    full = rng.normal(size=(b, m, d + 1)).astype(np.float32)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bf16" else (jnp.float32, torch.float32)
    jfull = jnp.asarray(full, jdt)
    tfull = torch.tensor(np.asarray(jfull.astype(jnp.float32))).to(tdt)
    jx, jws = J.split_fused_rows(jfull, d)
    tx, tws = K.split_fused_rows_reference(tfull, d)
    assert tx.dtype == tdt and tx.shape == (b, d, m) and tws.shape == (b,) and tws.dtype == torch.float32
    np.testing.assert_array_equal(_np(tx), np.asarray(jx.astype(jnp.float32)))
    # f32 sums of m values in another order: within m ulps of the sum of |x|
    tol = m * np.finfo(np.float32).eps * np.abs(_np(tfull[..., d])).sum(1).max()
    np.testing.assert_allclose(tws.numpy(), np.asarray(jws), rtol=0, atol=tol)
    # the CPU entry point is the plain version, and launches nothing
    before = K.split_fused_rows.launches
    ex, ews = get_op("split_fused_rows")(tfull, d)
    assert torch.equal(ex, tx) and torch.equal(ews, tws)
    assert K.split_fused_rows.launches == before


# --------------------------------------------------------- fused 2-layer CIN
@pytest.mark.parametrize("shape", [(16, 8, 26, 16, 16), (4, 16, 26, 128, 128)])
def test_cin2_reference_f32_matches_jax(cin_inputs, shape):
    b, d, m, h1, h2 = shape
    x_dm, w1, w2 = cin_inputs(b, d, m, h1, h2)
    want = np.asarray(J.cin_stack_dm_flat(jnp.asarray(x_dm), [jnp.asarray(w1), jnp.asarray(w2)]))
    x1, p1, p2, q = K.cin2_forward_reference(
        torch.from_numpy(x_dm.reshape(b * d, m)), torch.from_numpy(w1), torch.from_numpy(w2), d,
        want_x1=True, want_q=True,
    )
    got = torch.cat([p1, p2], 1).numpy()
    np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL * np.abs(want).max())
    o_x1, _, _, o_q = _oracle(x_dm, w1, w2)
    for g, w in ((x1, o_x1), (q, o_q)):
        np.testing.assert_allclose(g.numpy(), w, rtol=F32_TOL, atol=F32_TOL * np.abs(w).max())


@pytest.mark.parametrize("shape", [(16, 8, 26, 16, 16), (4, 16, 26, 128, 128), (3, 5, 7, 16, 32)])
def test_cin2_reference_bf16_within_rule_of_f32_oracle(cin_inputs, shape):
    b, d, m, h1, h2 = shape
    x_dm, w1, w2 = cin_inputs(b, d, m, h1, h2, seed=4)
    x0b, w1b, w2b = (torch.from_numpy(a).to(torch.bfloat16) for a in (x_dm.reshape(b * d, m), w1, w2))
    outs = K.cin2_forward_reference(x0b, w1b, w2b, d, want_x1=True, want_q=True)
    assert all(o.dtype == torch.bfloat16 for o in outs)
    assert [tuple(o.shape) for o in outs] == [(b * d, h1), (b, h1), (b, h2), (b, m * h1)]
    oracle = _oracle(*(_np(t) for t in (x0b.reshape(b, d, m), w1b, w2b)))
    for got, want in zip(outs, oracle):
        _close_rule(_np(got), want)
    # the dispatched entry is the same plain version on the CPU
    before = K.cin2_forward.launches
    pools = get_op("cin_stack_dm_flat")(x0b.reshape(b, d, m), [w1b, w2b])
    assert torch.equal(pools, torch.cat(outs[1:3], 1))
    assert K.cin2_forward.launches == before
    # and JAX's bf16 reference path (per-layer einsums) lands within the same rule
    jpools = J.cin_stack_dm_flat(
        jnp.asarray(x_dm.reshape(b, d, m), jnp.bfloat16),
        [jnp.asarray(w1, jnp.bfloat16), jnp.asarray(w2, jnp.bfloat16)],
    )
    _close_rule(_np(pools), np.asarray(jpools.astype(jnp.float32)))


# ------------------------------------------------------------- backward
def _jax_cin_vjp(x_dm, w1, w2, g1p, g2p):
    """jax.vjp of JAX's cin_stack_dm_flat in f32: (gx_dm, gw1, gw2)."""
    _, vjp = jax.vjp(lambda x, a, b: J.cin_stack_dm_flat(x, [a, b]),
                     *(jnp.asarray(t) for t in (x_dm, w1, w2)))
    return [np.asarray(g) for g in vjp(jnp.asarray(np.concatenate([g1p, g2p], 1)))]


def _pool_grads(b, h1, h2, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, h1)).astype(np.float32), rng.normal(size=(b, h2)).astype(np.float32))


def _port_cin_bwd(x_dm, w1, w2, g1p, g2p, dtype):
    b, d, m = x_dm.shape
    x02, w1t, w2t = (torch.from_numpy(a).to(dtype) for a in (x_dm.reshape(b * d, m), w1, w2))
    x1, _, _, q = K.cin2_forward_reference(x02, w1t, w2t, d, want_x1=True, want_q=True)
    before = K.cin2_backward.launches
    outs = K.cin2_backward(x02, x1, w1t, w2t, q, torch.from_numpy(g1p).to(dtype),
                           torch.from_numpy(g2p).to(dtype), d)
    assert K.cin2_backward.launches == before  # the CPU takes the plain version
    assert all(o.dtype == dtype for o in outs)
    gx0, gw1, gw2 = outs
    return gx0.reshape(b, d, m), gw1, gw2


@pytest.mark.parametrize("shape", [(16, 8, 26, 16, 16), (4, 16, 26, 128, 128), (3, 5, 7, 16, 32)])
def test_cin2_backward_reference_f32_matches_jax_vjp(cin_inputs, shape):
    b, d, m, h1, h2 = shape
    x_dm, w1, w2 = cin_inputs(b, d, m, h1, h2, seed=5)
    g1p, g2p = _pool_grads(b, h1, h2, 6)
    want = _jax_cin_vjp(x_dm, w1, w2, g1p, g2p)
    got = _port_cin_bwd(x_dm, w1, w2, g1p, g2p, torch.float32)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=F32_TOL, atol=F32_TOL * np.abs(w).max())


@pytest.mark.parametrize("shape", [(16, 8, 26, 16, 16), (4, 16, 26, 128, 128), (3, 5, 7, 16, 32)])
def test_cin2_backward_reference_bf16_within_rule_of_f32_vjp(cin_inputs, shape):
    """bf16 rounds t1p, gx1, gp, the pairs and the products the kernel
    rounds; the f32 oracle is jax.vjp on the same bf16-valued inputs."""
    b, d, m, h1, h2 = shape
    x_dm, w1, w2 = cin_inputs(b, d, m, h1, h2, seed=7)
    g1p, g2p = _pool_grads(b, h1, h2, 8)
    as_bf16 = [_np(torch.from_numpy(a).to(torch.bfloat16)) for a in (x_dm, w1, w2, g1p, g2p)]
    want = _jax_cin_vjp(*as_bf16)
    got = _port_cin_bwd(*as_bf16, torch.bfloat16)
    for g, w in zip(got, want):
        _close_rule(_np(g), w)


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_split_fused_rows_backward_reference_matches_jax_vjp(dtype):
    rng = np.random.default_rng(9)
    b, m, d = 37, 26, 8
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bf16" else (jnp.float32, torch.float32)
    full = jnp.asarray(rng.normal(size=(b, m, d + 1)), jdt)
    g_dm = jnp.asarray(rng.normal(size=(b, d, m)), jdt)
    g_ws = jnp.asarray(rng.normal(size=(b,)), jnp.float32)
    _, vjp = jax.vjp(lambda f: J.split_fused_rows(f, d), full)
    (want,) = vjp((g_dm, g_ws))
    tg_dm = torch.tensor(np.asarray(g_dm.astype(jnp.float32))).to(tdt)
    before = K.split_fused_rows_backward.launches
    got = K.split_fused_rows_backward(tg_dm, torch.tensor(np.asarray(g_ws)))
    assert K.split_fused_rows_backward.launches == before
    assert got.dtype == tdt and got.shape == (b, m, d + 1)
    np.testing.assert_array_equal(_np(got), np.asarray(want.astype(jnp.float32)))


def test_split_fused_rows_function_matches_autograd_of_plain_ops():
    rng = np.random.default_rng(10)
    full = torch.tensor(rng.normal(size=(9, 26, 17)), dtype=torch.float32).to(torch.bfloat16)
    g_dm = torch.tensor(rng.normal(size=(9, 16, 26)), dtype=torch.float32).to(torch.bfloat16)
    g_ws = torch.tensor(rng.normal(size=(9,)), dtype=torch.float32)
    grads = []
    for fn in (K.SplitFusedRows.apply, K.split_fused_rows_reference, get_op("split_fused_rows")):
        x = full.clone().requires_grad_(True)
        x_dm, ws = fn(x, 16)
        grads.append(torch.autograd.grad((x_dm.float() * g_dm.float()).sum() + (ws * g_ws).sum(), x)[0])
    assert grads[0].dtype == torch.bfloat16
    assert torch.equal(grads[0], grads[1]) and torch.equal(grads[2], grads[1])


def test_cin2_function_matches_autograd_of_plain_ops(cin_inputs):
    """``Cin2`` in f32 on the CPU (pool grads that bf16 holds, so its bf16
    cast changes nothing) against autograd through the plain per-layer
    ops; in bf16, ``cin_stack_dm_flat`` goes through it."""
    b, d, m, h1, h2 = 5, 8, 26, 16, 32
    x_dm, w1, w2 = cin_inputs(b, d, m, h1, h2, seed=11)
    g = torch.from_numpy(np.concatenate(_pool_grads(b, h1, h2, 12), 1)).to(torch.bfloat16).float()
    grads = []
    for path in ("function", "plain"):
        x, a, c = (torch.from_numpy(t).requires_grad_(True) for t in (x_dm, w1, w2))
        if path == "function":
            pools = torch.cat(K.Cin2.apply(x.reshape(b * d, m), a, c, d), 1)
        else:
            pools = T.cin_stack_dm_flat(x, [a, c])
        grads.append(torch.autograd.grad((pools * g).sum(), (x, a, c)))
    for got, want in zip(*grads):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=F32_TOL,
                                   atol=F32_TOL * want.abs().max().item())
    x = torch.from_numpy(x_dm).to(torch.bfloat16).requires_grad_(True)
    ws = [torch.from_numpy(w).to(torch.bfloat16) for w in (w1, w2)]
    pools = get_op("cin_stack_dm_flat")(x, ws)
    assert pools.grad_fn is not None and "Cin2" in pools.grad_fn.next_functions[0][0].name()


def test_product_function_matches_autograd_of_widened_product():
    """The MLP's bf16 product: grads are f32 sums rounded to bf16 (JAX's
    transpose rule), for a cotangent that bf16 holds (every MLP layer's
    output rounds to bf16)."""
    rng = np.random.default_rng(13)
    a0 = torch.tensor(rng.normal(size=(6, 5)), dtype=torch.float32).to(torch.bfloat16)
    b0 = torch.tensor(rng.normal(size=(5, 4)), dtype=torch.float32).to(torch.bfloat16)
    g = torch.tensor(rng.normal(size=(6, 4)), dtype=torch.float32).to(torch.bfloat16).float()
    grads = []
    for fn in (ProductF32.apply, lambda x, y: x.float() @ y.float()):
        a, b = a0.clone().requires_grad_(True), b0.clone().requires_grad_(True)
        out = fn(a, b)
        assert out.dtype == torch.float32
        grads.append(torch.autograd.grad((out * g).sum(), (a, b)))
    for got, want in zip(*grads):
        assert got.dtype == torch.bfloat16 and torch.equal(got, want)


# ------------------------------------------------------------------ dispatch
def test_dispatch_names_are_the_jax_packages():
    for name in ("cin_layer", "cin_stack", "cin_stack_dm", "cin_stack_flat",
                 "cin_stack_dm_flat", "split_fused_rows"):
        assert name in jdispatch._REFERENCE
        assert callable(get_op(name))
    with pytest.raises(KeyError):
        get_op("no_such_op")


@pytest.mark.parametrize("name", ["cin_layer", "cin_stack", "cin_stack_dm", "cin_stack_flat"])
def test_ops_without_a_kernel_raise_off_the_cpu(name):
    x = torch.empty((2, 3, 4), device="meta")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        get_op(name)(x, [])


def test_cin_stack_dm_flat_without_a_kernel_raises_off_the_cpu():
    x = torch.empty((2, 4, 3), device="meta")
    w = [torch.empty((3, 3 * 16), device="meta")] * 2
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        get_op("cin_stack_dm_flat")(x, w)  # f32: only bf16 has a kernel
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        get_op("cin_stack_dm_flat")(x.to(torch.bfloat16), w[:1] * 3)  # 3 layers


def test_kernel_entries_reject_devices_without_a_kernel():
    x = torch.empty((2, 3, 5), device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="no kernel"):
        K.split_fused_rows(x, 4)
    with pytest.raises(ValueError, match="no kernel"):
        K.cin2_forward(x.reshape(6, 5), x.reshape(6, 5), x.reshape(6, 5), 3)
    with pytest.raises(ValueError, match="no kernel"):
        K.split_fused_rows_backward(x, torch.empty((2,), device="meta"))
    y = x.reshape(6, 5)
    with pytest.raises(ValueError, match="no kernel"):
        K.cin2_backward(y, y, y, y, y, y, y, 3)
