"""The port's Wukong on the CPU, against the plain f32 reference of
``tests/plain_wukong.py`` (the JAX package has no such model), on seeded
random weights at a small size: 4 slots of 300-450 rows and dim 16, hotness
(3, 1, 2, 3), 13 dense features, bottom (32, 16), two layers of n_F = n_L =
3 (so layer 1 projects its 5 inputs to 6), FM rank 4, MLP_F 20 -> 24 -> 48
at layer 1, top (32, 16), batch 64. Every parameter is live (the LN scales
1 + N(0, 0.1), shifts and biases N(0, 0.1)). Ids repeat within a bag, across
a slot's columns and across examples.

Tolerances:
* f32: the port runs the reference's math with other summation orders
  (the bag sums in bag order; the FM's products as two ``bmm``s against
  ``X (X^T Y)``; LN's statistics; the stack's written-out backward against
  autograd): logits, losses, grads and three steps' parameters,
  accumulators and table to rtol 1e-5 (atol 1e-6 for values near 0, which
  carry the absolute error of their larger terms).
* bf16 (``compute_dtype``): every product's operands, the FM's ``Z`` and
  the LNs' inputs and outputs are rounded to bf16 (2^-9 relative), some 30
  roundings deep from the tables to the logit, and LN_d divides by a
  standard deviation computed from rounded values; the repo's bf16 rule for
  logits holds, 0.03 * max |logit| + 1e-3, and BCE is 1-Lipschitz in each
  logit, so the mean loss takes the same bound. A gradient is a batch sum
  of terms of both signs, many times smaller than the sum of their
  magnitudes, so the roundings' 1-2% on each term become more of the sum,
  and LN_d's rows of 16 values amplify the rounding of their inputs: over
  state seeds 0-11 the whole gradient (every dense leaf and the pooled rows)
  lies 0.7-6.0% of its norm from the reference's (seed 0, the tests', 4.2%).
  So the gradient and the change of the state over three steps (Adagrad's
  steps are the gradient's, scaled per element) are held as whole vectors
  to 10% of the reference's norm, as the DLRM-DCNv2 tests hold theirs. That
  catches a lost path (the residual's cotangent dropped reads 25-105% over
  those seeds, the FM's 10-54%), not every small leaf's lost grad (``Y``'s
  dropped reads 6-52%), so the f32 cases, which hold each element, are the
  check of every term.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import plain_wukong as plain
from recmodels_tpu_torch.data.schema import Schema, slot_spec
from recmodels_tpu_torch.models import build_model
from recmodels_tpu_torch.models.wukong import WukongModel
from recmodels_tpu_torch.nn.wukong_fm import fm_backward, fm_forward
from recmodels_tpu_torch.serve import Predictor
from recmodels_tpu_torch.train.engine import Engine
from recmodels_tpu_torch.utils import profiling, tree

HOT = (3, 1, 2, 3)
VOCABS = (300, 350, 400, 450)
DIM = 16
B = 64
N_FMB = N_LCB = 3
LR = 0.005
F32_TOL = dict(rtol=1e-5, atol=1e-6)
WIDTHS = dict(bottom=(32, DIM), top=(32, 16), n_layers=2, n_fmb=N_FMB, n_lcb=N_LCB, fm_rank=4, fmb_hidden=(24,))


def _schema(n_slots: int = len(HOT)) -> Schema:
    return Schema(n_dense=13, slots=tuple(slot_spec(f"c{i}", v, DIM, h)
                                          for i, (v, h) in enumerate(zip(VOCABS[:n_slots], HOT[:n_slots]))))


def _engine(dtype=torch.float32, schema: Schema | None = None, **widths) -> Engine:
    model = build_model("wukong", schema or _schema(), compute_dtype=dtype, **{**WIDTHS, **widths})
    return Engine(model, dense_optimizer="adagrad", sparse_optimizer="adagrad", dense_lr=LR, emb_lr=LR)


def _state(engine: Engine, seed: int = 0):
    """A state whose every parameter is live: LN scales 1 + N(0, 0.1), LN
    shifts and biases N(0, 0.1)."""
    state = engine.init(seed=seed, device="cpu")
    g = torch.Generator().manual_seed(seed + 100)

    def jitter(t, base):
        t.copy_(base + torch.randn(t.shape, generator=g) * 0.1)

    for layer in state.dense_params["layers"]:
        for k in ("ln_f_scale", "ln_scale"):
            jitter(layer[k], 1.0)
        for k in ("ln_f_shift", "ln_shift"):
            jitter(layer[k], 0.0)
        for mlp in layer["mlp"]:
            jitter(mlp["b"], 0.0)
    for mlp in state.dense_params["top"] + state.dense_params["bottom"]:
        jitter(mlp["b"], 0.0)
    return state


def _batch(schema: Schema, seed: int, b: int = B):
    """Slot-local ids [b, n_ids] with repeats: each slot draws from its 40
    lowest ids, and bag positions repeat the bag's first id a third of the
    time."""
    g = torch.Generator().manual_seed(seed)
    ids = torch.stack([torch.randint(0, 40, (b,), generator=g) for _ in schema.id_slots], dim=1)
    c = 0
    for h in schema.hotness:
        for j in range(c + 1, c + h):
            ids[:, j] = torch.where(torch.rand(b, generator=g) < 1 / 3, ids[:, c], ids[:, j])
        c += h
    dense = torch.log1p(torch.rand((b, schema.n_dense), generator=g) * 50)
    labels = (torch.rand(b, generator=g) < 0.3).float()
    return dense, ids.int(), labels


def _global_ids(engine: Engine, ids: torch.Tensor) -> torch.Tensor:
    (gids,) = engine.collections["emb"].group_row_ids(ids).values()
    return gids


def _table(state) -> torch.Tensor:
    (t,) = state.emb_params["emb"].values()
    return t


def _acc(state) -> torch.Tensor:
    (a,) = state.emb_opt["emb"].values()
    return a["acc"]


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().double().numpy(), want.detach().double().numpy(), **(tol or F32_TOL))


def _bf16_close(got, want):
    got, want = got.detach().float(), want.detach().float()
    assert float((got - want).abs().max()) <= 0.03 * float(want.abs().max()) + 1e-3


def _vector_close(got: list, want: list, share: float = 0.10):
    """The concatenated vectors within ``share`` of the reference's norm."""
    g = torch.cat([t.detach().double().reshape(-1) for t in got])
    w = torch.cat([t.detach().double().reshape(-1) for t in want])
    assert float((g - w).norm()) <= share * float(w.norm())


def _logits(engine, state, dense, ids):
    return plain.logits(state.dense_params, _table(state), dense, _global_ids(engine, ids), HOT, N_FMB)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_logits_match_the_plain_reference(dtype):
    engine = _engine(dtype)
    state = _state(engine)
    dense, ids, _ = _batch(engine.model.schema, 1)
    got = engine.logits(state, dense, ids)
    want = _logits(engine, state, dense, ids)
    assert got.shape == (B,) and got.dtype == torch.float32
    if dtype == torch.float32:
        _close(got, want)
    else:
        _bf16_close(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_loss_and_its_dense_and_pooled_grads_match(dtype):
    """``Engine._grads``: the loss, the dense grads (every leaf, in flatten
    order) and the pooled rows' grads [B, n_slots, d] against autograd of
    the plain model."""
    engine = _engine(dtype)
    state = _state(engine)
    dense, ids, labels = _batch(engine.model.schema, 2)
    loss, _, _, _, g_dense, g_rows = engine._grads(state, dense, ids, labels)
    (g_pooled,) = g_rows["emb"].values()
    params = plain.clone(state.dense_params, grad=True)
    e = plain.pooled(_table(state), _global_ids(engine, ids), HOT).requires_grad_(True)
    want = torch.nn.functional.binary_cross_entropy_with_logits(
        plain.logits_from_pooled(params, dense, e, N_FMB), labels)
    want_grads = torch.autograd.grad(want, plain.leaves(params) + [e])
    assert g_pooled.shape == (B, len(HOT), DIM) and len(g_dense) == len(want_grads) - 1
    if dtype == torch.float32:
        _close(loss, want)
        for got, ref in zip(g_dense + [g_pooled], want_grads):
            _close(got, ref)
    else:
        assert abs(float(loss) - float(want.detach())) <= 0.03 * 2 + 1e-3
        _vector_close(g_dense + [g_pooled], list(want_grads))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_three_train_steps_match(dtype):
    """Three ``Engine.train_step``s (dense and sparse Adagrad) against the
    plain model's: losses, dense parameters and accumulators, the table and
    its accumulator; rows no id names keep their bits."""
    engine = _engine(dtype)
    state = _state(engine)
    batches = [_batch(engine.model.schema, 10 + k) for k in range(3)]
    table0 = _table(state).clone()
    want_losses, want_params, want_sos, want_table, want_acc = plain.train(
        state.dense_params, table0, [(d, _global_ids(engine, i), lab) for d, i, lab in batches], HOT, N_FMB, LR, LR)
    start = [p.clone() for p in tree.leaves(state.dense_params)]
    losses = [float(engine.train_step(state, *bt)[1]["loss"]) for bt in batches]
    assert int(state.step) == 3
    touched = torch.zeros(table0.shape[0], dtype=torch.bool)
    for _, i, _ in batches:
        touched[_global_ids(engine, i).long().reshape(-1)] = True
    assert torch.equal(_table(state)[~touched], table0[~touched])
    assert bool((_acc(state)[~touched] == 0.1).all())
    got_leaves = list(tree.leaves(state.dense_params))
    want_leaves = plain.leaves(want_params)
    if dtype == torch.float32:
        np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
        for got, want in zip(got_leaves, want_leaves):
            _close(got, want)
        for got, want in zip(state.dense_opt["sum_of_squares"], want_sos):
            _close(got, want)
        _close(_table(state), want_table)
        _close(_acc(state), want_acc)
    else:
        assert max(abs(a - b) for a, b in zip(losses, want_losses)) <= 0.03 * 2 + 1e-3
        _vector_close([g - p0 for g, p0 in zip(got_leaves, start)] + [_table(state) - table0],
                      [w - p0 for w, p0 in zip(want_leaves, start)] + [want_table - table0])


def _fm_inputs(dtype, n=6, d=DIM, k=4, n_l=N_LCB, b=B, seed=3):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((b, n, d), generator=g).to(dtype)
    y = (torch.randn((n, k), generator=g) / n ** 0.5).to(dtype)
    w = (torch.randn((n, n_l), generator=g) / n ** 0.5).to(dtype)
    scale = 1 + 0.1 * torch.randn((n * k,), generator=g)
    shift = 0.1 * torch.randn((n * k,), generator=g)
    return x, y, w, scale, shift


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_fm_route_matches_the_reference_fm(dtype):
    """``nn/wukong_fm``'s plain route (the CPU's): ``a`` is the reference's
    LN_F of ``X (X^T Y)`` and ``l`` its ``W_L X``; its backward (``g_s``'s
    rows n_F.. ``l``'s cotangent, ``g_res`` added to X's) is autograd's of the
    reference. f32 to rtol 1e-5 (1e-5 absolute for the batch sums); bf16
    against the reference on the same rounded operands, the 0.03 logit rule
    on a and l (their rounding to bf16 and Z's), and the grads as whole
    vectors to 10% of the reference's norm (the module docstring)."""
    x, y, w, scale, shift = _fm_inputs(dtype)
    n_f = 2
    g = torch.Generator().manual_seed(4)
    g_a = torch.randn((B, x.shape[1] * y.shape[1]), generator=g).to(dtype)
    g_s = torch.randn((B, n_f + w.shape[1] + 1, DIM), generator=g).to(dtype)
    g_res = torch.randn(x.shape, generator=g).to(dtype)
    a, l, mean, rstd = fm_forward(x, y, w, scale, shift)
    ref = [t.detach().float().requires_grad_(True) for t in (x, y, w, scale, shift)]
    xr, yr, wr, sr, br = ref
    f = plain.fm(xr, yr).reshape(B, -1)
    a_ref = torch.nn.functional.layer_norm(f, (f.shape[1],), sr, br, plain.EPS)
    l_ref = wr.t() @ xr
    assert a.dtype == l.dtype == dtype and a.shape == a_ref.shape and l.shape == l_ref.shape
    g_l = g_s[:, n_f:n_f + w.shape[1]].float()
    want = torch.autograd.grad((a_ref * g_a.float()).sum() + (l_ref * g_l).sum() + (xr * g_res.float()).sum(), ref[:4])
    got = fm_backward(x, y, w, scale, mean, rstd, g_a, g_s, n_f, g_res)
    want_shift = g_a.float().sum(dim=0)
    if dtype == torch.float32:
        _close(mean, f.mean(dim=1))
        _close(a, a_ref)
        _close(l, l_ref)
        for t, r in zip(got, [*want, want_shift]):
            _close(t, r, rtol=1e-5, atol=1e-5)
    else:
        _bf16_close(mean, f.mean(dim=1))
        _bf16_close(a, a_ref)
        _bf16_close(l, l_ref)
        assert got[0].dtype == torch.bfloat16 and all(t.dtype == torch.float32 for t in got[1:])
        _vector_close(list(got), [*want, want_shift])


@pytest.mark.parametrize("n_slots,has_proj", [(4, True), (5, False)])
def test_residual_projection_only_where_the_widths_differ(n_slots, has_proj):
    """Layer 1 holds ``proj`` [n_0, n_F + n_L] where n_0 = slots + 1 differs
    from n_F + n_L (5 against 6), and none where they agree (6 against 6);
    later layers never do. Either way the f32 logits and grads are the
    reference's."""
    hot = (3, 1, 2, 3, 2)[:n_slots]
    schema = Schema(n_dense=13, slots=tuple(slot_spec(f"c{i}", 300 + 50 * i, DIM, h) for i, h in enumerate(hot)))
    engine = _engine(torch.float32, schema)
    state = _state(engine)
    layers = state.dense_params["layers"]
    assert ("proj" in layers[0]) == has_proj and "proj" not in layers[1]
    if has_proj:
        assert layers[0]["proj"].shape == (n_slots + 1, N_FMB + N_LCB)
    dense, ids, labels = _batch(schema, 6)
    loss, _, _, _, g_dense, _ = engine._grads(state, dense, ids, labels)
    params = plain.clone(state.dense_params, grad=True)
    want = plain.loss(params, _table(state), dense, _global_ids(engine, ids), labels, hot, N_FMB)
    _close(loss, want)
    for got, ref in zip(g_dense, torch.autograd.grad(want, plain.leaves(params))):
        _close(got, ref)


def test_captured_scan_on_the_cpu_equals_steps():
    """``jit_train_scan`` (no capture on the CPU) equals K ``train_step``s
    bit for bit, in bf16."""
    batches = [_batch(_schema(), 20 + k) for k in range(3)]
    e1, e2 = _engine(torch.bfloat16), _engine(torch.bfloat16)
    s1, s2 = _state(e1), _state(e2)
    for bt in batches:
        e1.train_step(s1, *bt)
    stacked = [torch.stack([bt[i] for bt in batches]) for i in range(3)]
    _, m = e2.jit_train_scan()(s2, *stacked)
    assert m["losses"].shape == (3,)
    for a, b in zip([*tree.leaves(s1.dense_params), _table(s1), _acc(s1)],
                    [*tree.leaves(s2.dense_params), _table(s2), _acc(s2)]):
        assert torch.equal(a, b)


def test_predictor_serves_bags():
    """``serve.Predictor`` on multi-hot ids: the reference's logits, and the
    CPU's FM route adds nothing to ``wukong.fm_layers`` (the kernels'
    counter)."""
    engine = _engine()
    state = _state(engine)
    dense, ids, _ = _batch(engine.model.schema, 5)
    before = profiling.snapshot()["counters"].get("wukong.fm_layers", 0)
    pred = Predictor(engine, state, torch.device("cpu"), min_bucket=16)
    got = pred.predict_logits(dense[:37].numpy(), ids[:37].numpy())
    _close(torch.from_numpy(got), _logits(engine, state, dense[:37], ids[:37]))
    assert profiling.snapshot()["counters"].get("wukong.fm_layers", 0) == before
    with pytest.raises(ValueError, match=r"ids must be \[B, 9\]"):
        pred.predict_logits(dense.numpy(), ids[:, :4].numpy())


@pytest.mark.parametrize("kwargs,match", [
    ({"bottom": (32, 12)}, "embedding dim"),
    ({"bottom": ()}, "embedding dim"),
    ({"n_layers": 0}, "at least 1"),
    ({"n_fmb": 0}, "at least 1"),
    ({"fm_rank": 0}, "at least 1"),
])
def test_constructor_checks(kwargs, match):
    with pytest.raises(ValueError, match=match):
        build_model("wukong", _schema(), **{**WIDTHS, **kwargs})


def test_constructor_refuses_slots_of_other_dims():
    schema = Schema(n_dense=13, slots=(slot_spec("a", 10, DIM, 1), slot_spec("b", 10, 8, 2)))
    with pytest.raises(ValueError, match="one embedding dim"):
        WukongModel(schema, bottom=(DIM,))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_residual_ln_route_matches_the_reference(dtype):
    """``nn/wukong_ln``'s plain route (the CPU's): ``s`` is ``concat(h, l) +
    r`` rounded once to the dtype, ``y`` the reference's LayerNorm of ``s``
    with the f32 scale and shift; its backward is autograd's of that
    LayerNorm at ``s``, ``g_h`` the first n_F rows of ``g_s``. f32 to rtol
    1e-5; bf16 ``y`` and ``g_s`` by the 0.03 rule (one rounding of each
    output), the f32 weight grads to 1e-5 (the same f32 sums)."""
    from recmodels_tpu_torch.nn.wukong_ln import residual_ln_backward, residual_ln_forward

    g = torch.Generator().manual_seed(8)
    n_f, n_l = 3, 2
    h = torch.randn((B, n_f * DIM), generator=g).to(dtype)
    l = torch.randn((B, n_l, DIM), generator=g).to(dtype)
    r = torch.randn((B, n_f + n_l, DIM), generator=g).to(dtype)
    scale = 1 + 0.1 * torch.randn((DIM,), generator=g)
    shift = 0.1 * torch.randn((DIM,), generator=g)
    cot = torch.randn(r.shape, generator=g).to(dtype)
    s, y, mean, rstd = residual_ln_forward(h, l, r, scale, shift)
    assert torch.equal(s, (torch.cat([h.reshape(B, n_f, DIM), l], dim=1).float() + r.float()).to(dtype))
    sr, wr, br = (t.detach().float().requires_grad_(True) for t in (s, scale, shift))
    want = torch.nn.functional.layer_norm(sr, (DIM,), wr, br, plain.EPS)
    want_grads = torch.autograd.grad((want * cot.float()).sum(), (sr, wr, br))
    g_s, g_h, g_scale, g_shift = residual_ln_backward(cot, s, mean, rstd, scale, n_f)
    assert y.dtype == g_s.dtype == g_h.dtype == dtype and torch.equal(g_h, g_s[:, :n_f].reshape(B, -1))
    _close(g_scale, want_grads[1], rtol=1e-5, atol=1e-5)
    _close(g_shift, want_grads[2], rtol=1e-5, atol=1e-5)
    if dtype == torch.float32:
        _close(y, want)
        _close(g_s, want_grads[0], rtol=1e-5, atol=1e-5)
    else:
        _bf16_close(y, want)
        _bf16_close(g_s, want_grads[0])
