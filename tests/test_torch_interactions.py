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
* the generic CIN layer: ``cin_layer_forward_reference`` against JAX's
  ``_cin_forward_2d`` and ``cin_layer_backward_reference`` against its
  ``_cin_bwd_pallas``, both in interpret mode; ``CinLayer2d`` (backward
  kernel or einsums, by JAX's condition) and ``TransposeMinor2`` against
  ``torch.autograd`` through the plain ops; 3-layer ``cin_stack_dm_flat``
  and ``cin_stack_flat`` and their grads against the JAX ops;
* the route: two-layer bf16 CINs of widths that are no multiples of 16
  (CIN(100,100), CIN(200,200)) through the fused route at widths padded to
  16 against JAX's layer path, the padding step against the unpadded plain
  math in f32, and the CINs past the fused limits layer by layer;
* the ops of PNN, NFM and AFM (``triu_pair_indices``, ``pnn_inner_products``,
  ``pnn_outer_product``, ``fm_bi_interaction``, ``afm_pair_products``),
  plain PyTorch on every device, and their grads against JAX's ops and
  ``jax.vjp``, in f32 and bf16;
* dispatch: what runs for a CPU tensor and what raises for other devices.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recmodels_tpu.ops import dispatch as jdispatch
from recmodels_tpu.ops import interactions as J
from recmodels_tpu.ops.pallas import interactions_tpu as JT
from recmodels_tpu_torch.nn.mlp import ProductF32
from recmodels_tpu_torch.ops import interactions as T
from recmodels_tpu_torch.ops.cuda import interactions_cuda as K
from recmodels_tpu_torch.ops.dispatch import get_op
from recmodels_tpu_torch.utils import profiling

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


@pytest.mark.parametrize("shape", [(16, 8, 26, 16, 16), (4, 16, 26, 128, 128), (3, 5, 7, 16, 32),
                                   (3, 32, 26, 16, 16)])
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


@pytest.mark.parametrize("shape", [(16, 8, 26, 16, 16), (4, 16, 26, 128, 128), (3, 5, 7, 16, 32),
                                   (3, 32, 26, 16, 16)])
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


@pytest.mark.parametrize("d,m,h1,h2,dtype,takes", [
    (16, 26, 128, 128, torch.bfloat16, True),    # the flagship
    (32, 26, 128, 128, torch.bfloat16, True),    # bench.py --dim 32
    (33, 26, 128, 128, torch.bfloat16, False),   # past 32 rows an example
    (1, 1, 16, 16, torch.bfloat16, True),        # the smallest
    (16, 32, 256, 256, torch.bfloat16, True),    # the widest
    (16, 33, 128, 128, torch.bfloat16, False),   # past 32 fields
    (16, 26, 272, 128, torch.bfloat16, False),   # h1 past 256
    (16, 26, 128, 272, torch.bfloat16, False),   # h2 past 256
    (16, 26, 100, 100, torch.bfloat16, False),   # not multiples of 16
    (16, 26, 240, 16, torch.bfloat16, True),
    (16, 26, 8, 128, torch.bfloat16, False),     # below 16
    (16, 26, 128, 128, torch.float32, False),    # f32 runs layer by layer
])
def test_cin2_takes_states_the_fused_kernels_limits(d, m, h1, h2, dtype, takes):
    assert K.cin2_takes(d, m, h1, h2, dtype) is takes


@pytest.mark.parametrize("d,m,h1,h2,dtype,widths", [
    (16, 26, 128, 128, torch.bfloat16, (128, 128)),  # the flagship, as it is
    (16, 26, 200, 200, torch.bfloat16, (208, 208)),  # the paper's Criteo width
    (16, 10, 100, 100, torch.bfloat16, (112, 112)),
    (16, 26, 8, 250, torch.bfloat16, (16, 256)),
    (1, 1, 1, 1, torch.bfloat16, (16, 16)),
    (16, 26, 257, 16, torch.bfloat16, None),         # past 256
    (16, 40, 100, 100, torch.bfloat16, None),        # past 32 fields
    (33, 26, 200, 200, torch.bfloat16, None),        # past 32 rows an example
    (16, 26, 200, 200, torch.float32, None),         # f32 runs layer by layer
])
def test_cin2_route_widths_pads_to_multiples_of_16(d, m, h1, h2, dtype, widths):
    assert K.cin2_route_widths(d, m, h1, h2, dtype) == widths


def _bf16_cin(b, d, m, hs, seed):
    """A field matrix [b, d, m], flat weights of widths ``hs`` at the
    model's initial scale and a cotangent of the pools, as JAX and torch
    bf16 arrays."""
    rng = np.random.default_rng(seed)
    arrays = [rng.normal(size=(b, d, m)).astype(np.float32)]
    for h_prev, h in zip((m, *hs), hs):
        arrays.append((rng.normal(size=(h_prev, m * h)) * np.sqrt(2.0 / (h_prev * m))).astype(np.float32))
    arrays.append(rng.normal(size=(b, sum(hs))).astype(np.float32))
    return _both(arrays, "bf16")


def _jax_layer_path(js):
    """JAX's CIN a layer at a time (interpret mode) and its vjp at the
    cotangent: (pools, grads)."""
    jout, vjp = jax.vjp(lambda *a: JT.cin_stack_dm_flat(a[0], list(a[1:])), *js[:-1])
    return jout, vjp(js[-1])


def _port_cin_and_grads(ts):
    ins = [t.clone().requires_grad_(True) for t in ts[:-1]]
    out = get_op("cin_stack_dm_flat")(ins[0], ins[1:])
    return out, torch.autograd.grad((out.float() * ts[-1].float()).sum(), ins)


def _within_3pct_of_jax(out, tgrads, jout, jgrads):
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == jout.shape
    _max_err_within(_np(out.detach()), jout.astype(jnp.float32), 0.03)
    for got, want in zip(tgrads, jgrads):
        assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
        _max_err_within(_np(got), want.astype(jnp.float32), 0.03)


@pytest.mark.parametrize("b,d,m,hs", [(4, 4, 40, (16, 16)), (4, 2, 6, (272, 272)), (8, 16, 10, (24, 40, 16))],
                         ids=["m40", "h272", "three_layers"])
def test_two_layer_bf16_cin_past_the_fused_limits_goes_layer_by_layer(monkeypatch, b, d, m, hs):
    """A 40-field CIN, CIN(272,272) and, beside them, a three-layer CIN: no
    width rounded to 16 lets ``cin2_takes`` admit the two-layer ones, and
    the fused kernels take two layers only, so ``cin_stack_dm_flat`` runs
    them layer by layer (``CinLayer2d``, the einsum backward: no layer is
    128-aligned), as JAX does (its layer path in interpret mode). Pools and
    their grads w.r.t. the field matrix and every weight by the repo's bf16
    rule (3%)."""
    monkeypatch.setattr(JT, "_INTERPRET", True)
    assert len(hs) == 3 or K.cin2_route_widths(d, m, *hs, torch.bfloat16) is None
    js, ts = _bf16_cin(b, d, m, hs, seed=41)
    jout, jgrads = _jax_layer_path(js)

    def refuse(*args, **kwargs):
        raise AssertionError("the fused CIN ran")

    monkeypatch.setattr(K, "cin2_forward", refuse)
    layers = []
    plain_layer = K.cin_layer_2d
    monkeypatch.setattr(K, "cin_layer_2d", lambda *a: layers.append(a[0].shape) or plain_layer(*a))
    out, tgrads = _port_cin_and_grads(ts)
    assert layers == [(b * d, h) for h in (m, *hs[:-1])]
    _within_3pct_of_jax(out, tgrads, jout, jgrads)


@pytest.mark.parametrize("b,d,m,hs", [(8, 16, 10, (100, 100)), (4, 8, 26, (200, 200))],
                         ids=["cin100", "cin200"])
def test_bf16_cin_off_16_takes_the_padded_fused_route(monkeypatch, b, d, m, hs):
    """bf16 CIN(100,100) and the paper's CIN(200,200): widths that are no
    multiples of 16 are zero-padded to 112 and 208 and take the fused
    kernels' route (``Cin2``, its plain versions on the CPU: the last layer
    pooled first, the pair products and Q rounded to bf16), counted as
    ``cin.fused_padded``. Against JAX's layer path (interpret mode), which
    computes x2 and pools it: pools and their grads w.r.t. the field matrix
    and both weights, in the weights' own shapes, by the repo's bf16 rule
    (3%)."""
    monkeypatch.setattr(JT, "_INTERPRET", True)
    js, ts = _bf16_cin(b, d, m, hs, seed=43)
    jout, jgrads = _jax_layer_path(js)

    def refuse(*args, **kwargs):
        raise AssertionError("the CIN ran layer by layer")

    monkeypatch.setattr(K, "cin_layer_2d", refuse)
    widths = []
    plain_forward = K.cin2_forward
    monkeypatch.setattr(K, "cin2_forward", lambda x02, w1, w2, d, **kw: widths.append(
        (w1.shape[1] // m, w2.shape[1] // m)) or plain_forward(x02, w1, w2, d, **kw))
    monkeypatch.setattr(profiling, "_counters", {})
    out, tgrads = _port_cin_and_grads(ts)
    assert widths == [tuple(-(-h // 16) * 16 for h in hs)]
    assert profiling.snapshot()["counters"] == {"cin.fused_padded": 1}
    _within_3pct_of_jax(out, tgrads, jout, jgrads)


def test_padded_cin2_equals_the_unpadded_plain_math_in_f32(cin_inputs):
    """The padding step on the plain versions in f32 (``cin2_pools`` at
    widths 112 and 208 for CIN(100,200)): the pools and the grads of x0, w1
    and w2 equal the unpadded ``cin2_forward_reference`` and
    ``cin2_backward_reference`` to f32 rounding, and the padded weights'
    gradients are exactly zero before autograd cuts them away. (An f32 CIN
    still goes layer by layer in ``cin_stack_dm_flat``.)"""
    b, d, m, h1, h2 = 5, 8, 26, 100, 200
    x_dm, w1, w2 = cin_inputs(b, d, m, h1, h2, seed=45)
    g1p, g2p = (torch.from_numpy(g).to(torch.bfloat16).float() for g in _pool_grads(b, h1, h2, 46))
    x02, w1t, w2t = (torch.from_numpy(a) for a in (x_dm.reshape(b * d, m), w1, w2))
    x1, p1, p2, q = K.cin2_forward_reference(x02, w1t, w2t, d, want_x1=True, want_q=True)
    want = [p1, p2, *K.cin2_backward_reference(x02, x1, w1t, w2t, q, g1p, g2p, d)]

    ins = [t.clone().requires_grad_(True) for t in (x02, w1t, w2t)]
    pools = K.cin2_pools(*ins, d, (112, 208))
    got = [*(p.detach() for p in pools),
           *torch.autograd.grad((pools[0] * g1p).sum() + (pools[1] * g2p).sum(), ins)]
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=F32_TOL, atol=F32_TOL * w.abs().max().item())

    w1p, w2p = K.cin2_pad_weights(w1t, w2t, m, 112, 208)
    x1p, _, _, qp = K.cin2_forward_reference(x02, w1p, w2p, d, want_x1=True, want_q=True)
    assert not x1p[:, h1:].any() and not qp.reshape(b, m, 112)[..., h1:].any()
    pad = torch.nn.functional.pad
    _, gw1p, gw2p = K.cin2_backward_reference(x02, x1p, w1p, w2p, qp, pad(g1p, (0, 12)), pad(g2p, (0, 8)), d)
    gw1p, gw2p = gw1p.reshape(m, m, 112), gw2p.reshape(112, m, 208)
    assert not gw1p[..., h1:].any() and not gw2p[h1:].any() and not gw2p[..., h2:].any()


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
    """Every CIN op now reaches kernel entries: on a device with no kernel
    (meta) the first of them raises, naming it."""
    x = torch.empty((2, 3, 4), device="meta")
    w = torch.empty((5, 3, 3), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        get_op(name)(x, x, w) if name == "cin_layer" else get_op(name)(x, [w])


def test_cin_stack_dm_flat_without_a_kernel_raises_off_the_cpu():
    """f32 and 3-layer bf16 CINs run layer by layer, so off the CPU they
    reach the layer kernel's entry, which raises on meta tensors."""
    x = torch.empty((2, 4, 3), device="meta")
    w = [torch.empty((3, 3 * 16), device="meta"), torch.empty((16, 3 * 16), device="meta")]
    with pytest.raises(ValueError, match="cin_layer_forward: no kernel"):
        get_op("cin_stack_dm_flat")(x, w)  # f32
    wb = [t.to(torch.bfloat16) for t in w]
    with pytest.raises(ValueError, match="cin_layer_forward: no kernel"):
        get_op("cin_stack_dm_flat")(x.to(torch.bfloat16), wb + wb[1:])  # 3 layers


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
    with pytest.raises(ValueError, match="no kernel"):
        K.transpose_minor2(x)
    with pytest.raises(ValueError, match="no kernel"):
        K.cin_layer_forward(y, y, y)
    with pytest.raises(ValueError, match="no kernel"):
        K.cin_layer_backward(y, y, y, y)


# ------------------------------------------------------- generic CIN layer
def _layer(rows, hk, m, hn, seed):
    rng = np.random.default_rng(seed)
    xk = rng.normal(size=(rows, hk)).astype(np.float32)
    x0 = rng.normal(size=(rows, m)).astype(np.float32)
    w2 = (rng.normal(size=(hk, m * hn)) * np.sqrt(2.0 / (hk * m))).astype(np.float32)
    return xk, x0, w2


def _both(arrays, dtype):
    """The same values as JAX and as torch arrays, in ``dtype``."""
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bf16" else (jnp.float32, torch.float32)
    js = [jnp.asarray(a, jdt) for a in arrays]
    return js, [torch.tensor(np.asarray(j.astype(jnp.float32))).to(tdt) for j in js]


def _max_err_within(got, want, frac):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert np.max(np.abs(got - want)) <= frac * np.max(np.abs(want)), (np.max(np.abs(got - want)),
                                                                        np.max(np.abs(want)))


@pytest.mark.parametrize("shape", [(512, 26, 26, 128), (512, 128, 26, 128), (300, 12, 5, 24)])
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_cin_layer_forward_reference_matches_jax(monkeypatch, shape, dtype):
    """JAX's ``_cin_forward_2d`` in interpret mode (its Pallas kernel for
    rows % 256 == 0, its einsum branch for the ragged case). Both sum t and
    the fold in f32 and cast once: f32 to rounding order (1e-4 of the
    largest value), bf16 one bf16 step of the largest value (2^-7)."""
    monkeypatch.setattr(JT, "_INTERPRET", True)
    js, ts = _both(_layer(*shape, seed=20), dtype)
    want = JT._cin_forward_2d(*js)
    before = K.cin_layer_forward.launches
    got = K.cin_layer_forward(*ts)
    assert K.cin_layer_forward.launches == before and got.dtype == ts[0].dtype
    _max_err_within(_np(got), want.astype(jnp.float32), 2 ** -7 if dtype == "bf16" else F32_TOL)


@pytest.mark.parametrize("m", [26, 7])
def test_cin_layer_backward_reference_matches_jax_kernel(monkeypatch, m):
    """JAX's ``_cin_bwd_pallas`` in interpret mode at rows 512, Hk = Hn =
    128, bf16: the same rounding points (t1, q, z in bf16; every sum f32) in
    other summation orders, so a t1 value may round one bf16 step apart: 1%
    of the largest magnitude of each cotangent."""
    monkeypatch.setattr(JT, "_INTERPRET", True)
    rows, hk, hn = 512, 128, 128
    xk, x0, w2 = _layer(rows, hk, m, hn, seed=21)
    g = np.random.default_rng(22).normal(size=(rows, hn)).astype(np.float32)
    js, ts = _both((xk, x0, w2, g), "bf16")
    want = JT._cin_bwd_pallas(*js)
    got = K.cin_layer_backward(*ts)
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16 and tuple(a.shape) == b.shape
        _max_err_within(_np(a), b.astype(jnp.float32), 0.01)


@pytest.mark.parametrize("case", ["layer1_bf16", "aligned_bf16", "aligned_f32", "ragged_bf16"])
def test_cin_layer_function_matches_autograd_of_plain_ops(case):
    """``CinLayer2d`` against autograd through the plain forward. The
    backward takes the kernel exactly where JAX takes ``_cin_bwd_pallas``
    (aligned bf16 layers of rows % 512 == 0); layer 1 (Hk = m), f32 and
    ragged rows take the einsums. f32 to rounding order; bf16 by the repo's
    rule (3% of the largest value): both round the cotangents at other
    points than the f32 autograd does."""
    rows, hk, m, hn, dtype, kernel = {
        "layer1_bf16": (512, 26, 26, 128, "bf16", False),
        "aligned_bf16": (512, 128, 26, 128, "bf16", True),
        "aligned_f32": (512, 128, 26, 128, "f32", False),
        "ragged_bf16": (500, 128, 26, 128, "bf16", False),
    }[case]
    _, ts = _both(_layer(rows, hk, m, hn, seed=23), dtype)
    cot = torch.from_numpy(np.random.default_rng(24).normal(size=(rows, hn)).astype(np.float32))
    cot = cot.to(ts[0].dtype).float()
    assert K.takes_backward_kernel(*ts) == kernel
    grads = []
    for fn in (K.CinLayer2d.apply, K.cin_layer_forward_reference):
        ins = [t.clone().requires_grad_(True) for t in ts]
        grads.append(torch.autograd.grad((fn(*ins).float() * cot).sum(), ins))
    for got, want in zip(*grads):
        assert got.dtype == want.dtype
        _max_err_within(_np(got), _np(want), 0.03 if dtype == "bf16" else F32_TOL)


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_transpose_minor2_function_matches_jax_and_autograd(dtype):
    rng = np.random.default_rng(25)
    (jx,), (tx,) = _both([rng.normal(size=(9, 26, 16))], dtype)
    cot = torch.tensor(rng.normal(size=(9, 16, 26)), dtype=torch.float32).to(tx.dtype)
    got = K.transpose_minor2(tx)
    assert got.is_contiguous() and torch.equal(got.float(), torch.tensor(np.asarray(
        JT.transpose_minor2(jx).astype(jnp.float32))))
    grads = []
    for fn in (K.TransposeMinor2.apply, lambda x: x.transpose(1, 2)):
        x = tx.clone().requires_grad_(True)
        grads.append(torch.autograd.grad((fn(x).float() * cot.float()).sum(), x)[0])
    assert torch.equal(grads[0], grads[1])


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_transpose_minor2_takes_any_item_on_the_cpu(dtype):
    """The kernel's item limit (``TRANSPOSE_MAX_ITEM_BYTES``) holds on the
    card only: on the CPU an item past it takes the plain version and
    matches JAX's transpose."""
    rng = np.random.default_rng(26)
    (jx,), (tx,) = _both([rng.normal(size=(2, 520, 64))], dtype)
    assert tx[0].numel() * tx.element_size() > K.TRANSPOSE_MAX_ITEM_BYTES
    got = K.transpose_minor2(tx)
    assert got.shape == (2, 64, 520) and torch.equal(got.float(), torch.tensor(np.asarray(
        JT.transpose_minor2(jx).astype(jnp.float32))))


@pytest.mark.parametrize("op", ["cin_stack_dm_flat", "cin_stack_flat"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_three_layer_cin_matches_jax(monkeypatch, op, dtype):
    """CIN(128, 128, 128) on 512 rows (b = 32, d = 16, m = 10) against the
    JAX ops in interpret mode, the pools and their grads w.r.t. the field
    matrix and the three weights. JAX runs its layer kernels there (the
    backward kernel on layers 2 and 3, the einsums on layer 1), the port
    their plain versions. f32 to rounding order (1e-4 of the largest
    value); bf16 by the repo's rule (3%): the layers' bf16 outputs may round
    one step apart and carry that into the next layer."""
    monkeypatch.setattr(JT, "_INTERPRET", True)
    b, d, m, hs = 32, 16, 10, (128, 128, 128)
    rng = np.random.default_rng(26)
    x = rng.normal(size=(b, d, m) if op == "cin_stack_dm_flat" else (b, m, d)).astype(np.float32)
    ws, h = [], m
    for hn in hs:
        ws.append((rng.normal(size=(h, m * hn)) * np.sqrt(2.0 / (h * m))).astype(np.float32))
        h = hn
    cot = rng.normal(size=(b, sum(hs))).astype(np.float32)
    js, ts = _both([x, *ws, cot], dtype)
    jout, vjp = jax.vjp(lambda *a: getattr(JT, op)(a[0], list(a[1:])), *js[:-1])
    jgrads = vjp(js[-1])
    ins = [t.clone().requires_grad_(True) for t in ts[:-1]]
    out = get_op(op)(ins[0], ins[1:])
    assert out.dtype == ins[0].dtype and tuple(out.shape) == jout.shape
    tgrads = torch.autograd.grad((out.float() * ts[-1].float()).sum(), ins)
    frac = 0.03 if dtype == "bf16" else F32_TOL
    _max_err_within(_np(out.detach()), jout.astype(jnp.float32), frac)
    for got, want in zip(tgrads, jgrads):
        assert got.dtype == ins[0].dtype
        _max_err_within(_np(got), want.astype(jnp.float32), frac)


# ---------------------------------------------------------------- FM term
def _fm_inputs(b, f, d, dtype, seed, packed=True):
    """emb [B, F, D] as JAX and torch arrays of the same values; unless
    ``packed``, the torch side is the engine's view ``full[..., :D]`` of
    fused rows [B, F, D+1] (field rows D+1 apart)."""
    rng = np.random.default_rng(seed)
    full = rng.normal(size=(b, f, d + 1)).astype(np.float32)
    (jfull,), (tfull,) = _both([full], dtype)
    return jfull[..., :d], (tfull[..., :d].contiguous() if packed else tfull[..., :d])


def _fm_scale(emb: np.ndarray) -> np.ndarray:
    """Per example ||sum_f e_f||^2 + sum_f ||e_f||^2: the FM term is their
    halved difference, which cancels, so errors are held to this sum."""
    e = np.asarray(emb, np.float64)
    return (e.sum(1) ** 2).sum(1) + (e ** 2).sum((1, 2))


@pytest.mark.parametrize("b", [512, 97], ids=["tiled", "ragged"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_fm_pairwise_matches_jax(monkeypatch, b, dtype):
    """The port's plain version (and the CPU entry, on the strided view)
    against JAX's reference and JAX's Pallas kernel in interpret mode (B =
    512 takes the kernel's tile, 97 its ragged fallback). Per example, to a
    share of ||sum e||^2 + sum ||e||^2: f32 1e-5 (sums of 26 values in
    another order); bf16 1%: the same rounding points, but XLA may keep f32
    between fused bf16 steps, and one side keeping s_d unrounded moves s_d^2
    by 2^-8 of itself, each other rounding (s*s, the two sums, the
    difference) by 2^-9 of the scale, 0.98% in all at worst."""
    monkeypatch.setattr(JT, "_INTERPRET", True)
    jemb, temb = _fm_inputs(b, 26, 16, dtype, seed=30, packed=False)
    tol = (1e-5 if dtype == "f32" else 1e-2) * _fm_scale(_np(temb))
    got = T.fm_pairwise(temb.contiguous())
    assert got.dtype == temb.dtype and got.shape == (b,)
    before = K.fm_pairwise_forward.launches
    assert torch.equal(get_op("fm_pairwise")(temb), got)  # the view, by the CPU entry
    assert K.fm_pairwise_forward.launches == before
    for want in (J.fm_pairwise(jemb), JT.fm_pairwise(jemb)):
        err = np.abs(_np(got) - np.asarray(want.astype(jnp.float32)))
        assert np.all(err <= tol), (err.max(), tol.min())


@pytest.mark.parametrize("b", [512, 97], ids=["tiled", "ragged"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_fm_pairwise_grad_matches_jax_vjp(monkeypatch, b, dtype):
    """``FmPairwise`` on the strided view (the engine's input) against
    jax.vjp of JAX's kernel entry (its custom VJP, ``_fm_bwd``) and of its
    reference (autodiff): f32 to 1e-5 of the largest grad (the same
    formula, 26-term sums in another order); bf16 by the repo's rule, 3%:
    autodiff of the reference rounds at other points than ``_fm_bwd``."""
    monkeypatch.setattr(JT, "_INTERPRET", True)
    jemb, temb = _fm_inputs(b, 26, 16, dtype, seed=31, packed=False)
    g = np.random.default_rng(32).normal(size=(b,)).astype(np.float32)
    (jg,), (tg,) = _both([g], dtype)
    x = temb.detach().requires_grad_(True)
    (got,) = torch.autograd.grad((get_op("fm_pairwise")(x).float() * tg.float()).sum(), x)
    assert got.dtype == temb.dtype and got.shape == temb.shape
    frac = F32_TOL / 10 if dtype == "f32" else 0.03
    for fn in (JT.fm_pairwise, J.fm_pairwise):
        _, vjp = jax.vjp(fn, jemb)
        (want,) = vjp(jg)
        _max_err_within(_np(got), want.astype(jnp.float32), frac)


def test_fm_pairwise_function_matches_autograd_of_plain_op():
    """f32: ``FmPairwise``'s backward, (s - e) g, against autograd through
    the plain sum-square formula: the same values to f32 rounding."""
    _, temb = _fm_inputs(40, 26, 16, "f32", seed=33)
    g = torch.from_numpy(np.random.default_rng(34).normal(size=(40,)).astype(np.float32))
    grads = []
    for fn in (K.FmPairwise.apply, T.fm_pairwise):
        x = temb.clone().requires_grad_(True)
        grads.append(torch.autograd.grad((fn(x) * g).sum(), x)[0])
    torch.testing.assert_close(grads[0], grads[1], rtol=1e-5, atol=1e-5 * grads[1].abs().max().item())


# ------------------------------------------------------- DCN cross stack
def _dcn_inputs(b, d, n_layers, dtype, seed):
    rng = np.random.default_rng(seed)
    x0 = rng.normal(size=(b, d)).astype(np.float32)
    w = (rng.normal(size=(n_layers, d)) / np.sqrt(d)).astype(np.float32)
    bias = (rng.normal(size=(n_layers, d)) * 0.1).astype(np.float32)
    return _both([x0, w, bias], dtype)


@pytest.mark.parametrize("b,d", [(512, 429), (97, 429), (512, 24)], ids=["tiled", "ragged", "narrow"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_dcn_cross_stack_matches_jax(monkeypatch, b, d, dtype):
    """Three layers against JAX's reference and JAX's Pallas kernel in
    interpret mode (B = 512 takes its 256-row tiles, 97 its ragged
    fallback), at DCN's odd width 429 and at 24, element by element to a
    share of ``dcn_cross_stack_scale``, as the card's checks hold the
    kernel: f32 1e-5 (each t a d-term sum in another order); bf16 2^-5: the
    same rounding points, but a t that lands one bf16 step apart (XLA may
    keep f32 between fused steps) moves x0 * t by 2^-8 of t, and the next
    layer's t by that times x0 . w."""
    monkeypatch.setattr(JT, "_INTERPRET", True)
    js, ts = _dcn_inputs(b, d, 3, dtype, seed=35)
    before = K.dcn_cross_stack_forward.launches
    got = get_op("dcn_cross_stack")(*ts)
    assert K.dcn_cross_stack_forward.launches == before
    assert got.dtype == ts[0].dtype and got.shape == (b, d)
    assert torch.equal(got, T.dcn_cross_stack(*ts))
    tol = (1e-5 if dtype == "f32" else 2.0 ** -5) * K.dcn_cross_stack_scale(*ts).numpy()
    for want in (J.dcn_cross_stack(*js), JT.dcn_cross_stack(*js)):
        err = np.abs(_np(got).astype(np.float64) - np.asarray(want.astype(jnp.float32), np.float64))
        assert np.all(err <= tol)


@pytest.mark.parametrize("b,d", [(512, 429), (97, 24)], ids=["tiled", "ragged"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_dcn_cross_stack_grads_match_jax_vjp(monkeypatch, b, d, dtype):
    """``DcnCrossStack`` (JAX's ``_dcn_bwd`` in PyTorch ops) against jax.vjp
    of JAX's kernel entry in interpret mode: gx0, gw and gb. f32 to 1e-5 of
    each grad's largest value (gw and gb sum B rows, gx0 d-term dots: other
    orders); bf16 by the repo's rule, 3% (the chain is recomputed in bf16
    and a rounding one step apart carries through the layers)."""
    monkeypatch.setattr(JT, "_INTERPRET", True)
    js, ts = _dcn_inputs(b, d, 3, dtype, seed=36)
    cot = np.random.default_rng(37).normal(size=(b, d)).astype(np.float32)
    (jc,), (tc,) = _both([cot], dtype)
    _, vjp = jax.vjp(JT.dcn_cross_stack, *js)
    want = vjp(jc)
    ins = [t.clone().requires_grad_(True) for t in ts]
    got = torch.autograd.grad((get_op("dcn_cross_stack")(*ins).float() * tc.float()).sum(), ins)
    frac = 1e-5 if dtype == "f32" else 0.03
    for gt_, wt in zip(got, want):
        assert gt_.dtype == ts[0].dtype and tuple(gt_.shape) == wt.shape
        _max_err_within(_np(gt_), wt.astype(jnp.float32), frac)


def test_dcn_cross_stack_function_matches_autograd_of_plain_ops():
    """f32: the recompute-and-walk-back backward against autograd through
    the plain layers, to f32 rounding."""
    _, ts = _dcn_inputs(64, 37, 3, "f32", seed=38)
    cot = torch.from_numpy(np.random.default_rng(39).normal(size=(64, 37)).astype(np.float32))
    grads = []
    for fn in (K.DcnCrossStack.apply, T.dcn_cross_stack):
        ins = [t.clone().requires_grad_(True) for t in ts]
        grads.append(torch.autograd.grad((fn(*ins) * cot).sum(), ins))
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * want.abs().max().item())


@pytest.mark.parametrize("b,d,n_layers", [(4096, 429, 3), (97, 1024, 6), (300, 5, 2), (256, 1053, 3),
                                          (128, 1677, 3), (256, 429, 15)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_dcn_cross_stack_in_kernel_order_within_the_card_tolerance(b, d, n_layers, dtype):
    """The card's checks hold the kernel element by element to a share of
    ``dcn_cross_stack_scale`` (bf16 2^-5, f32 1e-5) and, in bf16, bit for
    bit to ``dcn_cross_stack_in_kernel_order``. So the plain version summed
    in the kernel's order must pass the first check here, and a stack that
    lost its last bias, a fault of the size of b ~ N(0, 0.1), must fail it.
    d = 1,053 and 1,677 (``--dim 40``, ``--dim 64``) and 15 f32 layers take
    the kernel's wide-row path, whose order the emulation follows too."""
    _, (x0, w, bias) = _dcn_inputs(b, d, n_layers, dtype, seed=40)
    rel = 1e-5 if dtype == "f32" else 2.0 ** -5
    scale = K.dcn_cross_stack_scale(x0, w, bias)
    want = T.dcn_cross_stack(x0, w, bias).double()
    in_order = K.dcn_cross_stack_in_kernel_order(x0, w, bias)
    assert in_order.dtype == x0.dtype and in_order.shape == (b, d)
    assert torch.all((in_order.double() - want).abs() <= rel * scale)
    lost = (in_order.double() - bias[-1].double()).to(x0.dtype).double()
    assert not torch.all((lost - want).abs() <= rel * scale)


@pytest.mark.parametrize("d,n_layers,dtype,registers", [
    (429, 3, torch.bfloat16, True),     # DCN's cell
    (1024, 6, torch.float32, True),     # the register path's edges: 1024 values, 48 KB
    (1025, 1, torch.bfloat16, False),   # past 32 values a lane
    (429, 15, torch.float32, False),    # w and b past 48 KB
    (429, 28, torch.bfloat16, True),
    (1053, 3, torch.bfloat16, False),   # bench.py --model dcn --dim 40
])
def test_dcn_rows_in_registers_routes_by_width_and_weights(d, n_layers, dtype, registers):
    assert K.dcn_rows_in_registers(d, n_layers, dtype) is registers


@pytest.mark.parametrize("name", ["fm_pairwise", "dcn_cross_stack", "dcn_cross_layer"])
def test_fm_and_dcn_dispatch_names_are_the_jax_packages(name):
    """The three names JAX dispatches; ``dcn_cross_layer`` has a kernel in
    neither package, so it is the plain op on every device (it runs on meta
    tensors), while the other two reach kernel entries that raise there."""
    assert name in jdispatch._REFERENCE
    if name == "dcn_cross_layer":
        assert get_op(name) is T.dcn_cross_layer
        x = torch.empty((4, 6), device="meta")
        assert get_op(name)(x, x, x[0], x[0]).shape == (4, 6)
        return
    x = torch.empty((4, 3, 6), device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match=f"{name}: no kernel"):
        get_op(name)(x) if name == "fm_pairwise" else get_op(name)(x[:, 0], x[:3, 0], x[:3, 0])


# ------------------------------------------------- PNN, NFM and AFM ops
ZOO_OPS = ("pnn_inner_products", "pnn_outer_product", "fm_bi_interaction", "afm_pair_products")


def _zoo_scale(name: str, emb: np.ndarray) -> np.ndarray:
    """Per output value, the sum of the magnitudes its formula adds (in f64):
    a rounding of any term or sum moves the value by a share of it, however
    much the terms cancel."""
    e = np.asarray(emb, np.float64)
    fi, fj = J.triu_pair_indices(e.shape[1])
    s = np.abs(e).sum(1)  # bounds |sum_f e_f| and what its sum adds
    if name == "pnn_inner_products":
        return np.abs(e[:, fi] * e[:, fj]).sum(-1)
    if name == "pnn_outer_product":
        return s[:, :, None] * s[:, None, :]
    if name == "fm_bi_interaction":
        return s * s + (e * e).sum(1)
    return np.abs(e[:, fi] * e[:, fj])


@pytest.mark.parametrize("n", [2, 5, 26])
def test_triu_pair_indices_are_jaxs(n):
    """The pair order of every product op: ``np.triu_indices`` row-major,
    (0, 1), (0, 2), ..., the order JAX's slices of AFM's pairs keep."""
    for got, want in zip(T.triu_pair_indices(n), J.triu_pair_indices(n)):
        assert got.dtype == want.dtype == np.int32 and np.array_equal(got, want)
    assert T.triu_pair_indices(n)[0].size == n * (n - 1) // 2


@pytest.mark.parametrize("name", ZOO_OPS)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_zoo_ops_match_jax(name, dtype):
    """Each op on the engine's strided view ``full[..., :16]`` of fused rows
    (B = 97, 26 fields) against JAX's reference on the same values, per
    value to a share of ``_zoo_scale``: f32 1e-6 (sums of 16 or 26 values
    in another order); bf16 2^-7: the same rounding points (each op's
    docstring), but a sum in another order may round one bf16 step (2^-8 of
    the scale at most) apart, and a rounded input of a difference moves the
    difference by as much. AFM's pair products are one rounded product
    each: bit for bit in both dtypes."""
    jemb, temb = _fm_inputs(97, 26, 16, dtype, seed=40, packed=False)
    got = getattr(T, name)(temb)
    want = np.asarray(getattr(J, name)(jemb).astype(jnp.float32))
    assert got.dtype == temb.dtype and tuple(got.shape) == want.shape
    if name == "afm_pair_products":
        assert np.array_equal(_np(got), want)
        return
    frac = 1e-6 if dtype == "f32" else 2.0 ** -7
    err = np.abs(_np(got) - want)
    tol = frac * _zoo_scale(name, _np(temb))
    assert np.all(err <= tol), (err.max(), (err / tol).max())


@pytest.mark.parametrize("name", ZOO_OPS)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_zoo_op_grads_match_jax_vjp(name, dtype):
    """The grads on the strided view (the engine's leaf) against
    ``jax.vjp`` of JAX's reference: f32 to 1e-5 of the largest grad (the
    same formulas, sums in another order); bf16 by the repo's rule, 3%:
    autograd of the port's forms (PNN's f32 Gram product, AFM's symmetric
    grid, summed in f32 and rounded once) rounds at other points than JAX's
    autodiff."""
    jemb, temb = _fm_inputs(97, 26, 16, dtype, seed=41, packed=False)
    shape = np.asarray(getattr(J, name)(jemb)).shape
    g = np.random.default_rng(42).normal(size=shape).astype(np.float32)
    (jg,), (tg,) = _both([g], dtype)
    x = temb.detach().requires_grad_(True)
    (got,) = torch.autograd.grad((getattr(T, name)(x).float() * tg.float()).sum(), x)
    assert got.dtype == temb.dtype and got.shape == temb.shape
    _, vjp = jax.vjp(getattr(J, name), jemb)
    (want,) = vjp(jg)
    _max_err_within(_np(got), want.astype(jnp.float32), 1e-5 if dtype == "f32" else 0.03)


def test_afm_pair_products_function_matches_autograd_of_plain_ops():
    """f32: ``AfmPairProducts``'s backward (the symmetric grid of pair grads,
    each field's row summed in order) against autograd through JAX's own
    form, the row-major slices ``e_i * e_{i+1:}``: the same values to f32
    rounding; and two backwards give the same bits."""
    _, temb = _fm_inputs(40, 26, 16, "f32", seed=43)
    g = torch.from_numpy(np.random.default_rng(44).normal(size=(40, 325, 16)).astype(np.float32))

    def slices(e):
        return torch.cat([e[:, i:i + 1] * e[:, i + 1:] for i in range(e.shape[1] - 1)], dim=1)

    grads = []
    for fn in (T.AfmPairProducts.apply, T.AfmPairProducts.apply, slices):
        x = temb.clone().requires_grad_(True)
        out = fn(x)
        assert torch.equal(out.detach(), slices(temb))
        grads.append(torch.autograd.grad((out * g).sum(), x)[0])
    assert torch.equal(grads[0], grads[1])
    torch.testing.assert_close(grads[0], grads[2], rtol=1e-5, atol=1e-5 * grads[2].abs().max().item())


@pytest.mark.parametrize("name", ["pnn_inner_products", "pnn_outer_product"])
def test_pnn_dispatch_names_are_the_jax_packages(name):
    """PNN's two dispatched ops have a kernel in neither package: the plain
    op on every device, under JAX's names."""
    assert name in jdispatch._REFERENCE
    assert get_op(name) is getattr(T, name)
