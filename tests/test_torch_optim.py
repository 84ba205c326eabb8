"""The port's optimizers on the CPU against the JAX package.

* stream prep (``slot_sorted_ids``, its inverse, ``dedup_segment_sum``)
  against ``recmodels_tpu.embedding.optim``, exactly;
* the sorted Adagrad update's plain version against JAX's
  ``sparse_adagrad().apply`` and against the TPU kernel
  ``pallas_update.sorted_adagrad_update_packed`` (and, for a dim-1 table,
  ``sorted_adagrad_update``) run in interpret mode;
* ``apply_updates`` (sort, permute, sorted update) against JAX's;
* lazy Adam's plain version against JAX's ``sparse_adam().apply`` (dedup +
  apply) and against the TPU kernel ``sorted_adam_update_packed`` in
  interpret mode, a touched id whose grads sum to exactly 0 included (it
  must decay); ``apply_updates`` for ``"adam"`` and ``"adam_dense"`` against
  JAX's (dense Adam decays the untouched rows too);
* the dense Adam, Adagrad and SGD against optax over a few steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from recmodels_tpu.embedding import optim as J
from recmodels_tpu.embedding import pallas_gather, pallas_update
from recmodels_tpu_torch.embedding import optim as T
from recmodels_tpu_torch.embedding.update import adam_scalars, sorted_adagrad_update, sorted_adam_update
from recmodels_tpu_torch.train import optim as TO

# the TPU kernel's own tolerances against sparse Adagrad
# (tests/test_tpu_kernels.py): its duplicate sums run in another order and
# the compiler may contract acc + g*g into one FMA
TABLE_TOL = dict(rtol=1e-4, atol=1e-6)
ACC_TOL = dict(rtol=3e-4, atol=1e-5)
# f32 elementwise optimizer math in another association or with FMA: ulps
F32_TOL = dict(rtol=1e-6, atol=1e-7)
# the TPU Adam kernel's own tolerance against sparse_adam
# (tests/test_pallas_update.py): duplicate sums in another order
ADAM_KERNEL_TOL = dict(rtol=2e-5, atol=1e-6)
B1, B2, EPS = 0.9, 0.999, 1e-8


def _lr(x: float) -> torch.Tensor:
    """A learning rate as the updates take it: a 0-d f32 tensor."""
    return torch.tensor(x, dtype=torch.float32)


def _step(x: int) -> torch.Tensor:
    """A global step as the updates take it: a 0-d int32 tensor."""
    return torch.tensor(x, dtype=torch.int32)


def _ids_2d(b=40, vocab=(7, 50, 3, 200), seed=0):
    """[b, n_slots] global row ids, slot s owning rows [off_s, off_s + v_s):
    small vocabs so that ids repeat."""
    rng = np.random.default_rng(seed)
    offsets = np.cumsum((0,) + vocab[:-1])
    cols = [rng.integers(0, v, size=b) + o for v, o in zip(vocab, offsets)]
    return np.stack(cols, axis=1).astype(np.int32), int(sum(vocab))


def _stream(rows=2048, dim=17, n=500, hot=0.3, seed=1, bf16_grads=False):
    """A sorted stream with a hot id (``hot`` of the entries) and two
    sentinels at the tail, grads N(0, 1)."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, rows - 24, size=n)
    ids[rng.random(n) < hot] = 777
    ids = np.sort(ids)
    ids[-2:] = [rows, rows + 5]  # sentinels
    shape = (n,) if dim == 1 else (n, dim)
    grads = rng.normal(size=shape).astype(np.float32)
    if bf16_grads:  # values a bf16 grad can hold
        grads = np.asarray(jnp.asarray(grads, jnp.bfloat16).astype(jnp.float32))
    tshape = (rows,) if dim == 1 else (rows, dim)
    table = rng.normal(size=tshape).astype(np.float32)
    acc = (np.abs(rng.normal(size=tshape)) + 0.1).astype(np.float32)
    return table, acc, ids.astype(np.int32), grads


def _port_update(table, acc, ids, grads, lr, eps, bf16_grads=False):
    t, a = torch.tensor(table), torch.tensor(acc)
    g = torch.tensor(grads)
    if bf16_grads:
        g = g.to(torch.bfloat16)
    before = sorted_adagrad_update.launches
    sorted_adagrad_update(t, a, torch.tensor(ids), g, _lr(lr), eps)
    assert sorted_adagrad_update.launches == before  # the CPU takes the plain version
    return t.numpy(), a.numpy()


# ------------------------------------------------------------ stream prep
@pytest.mark.parametrize("seed", [0, 1])
def test_slot_sorted_ids_and_inverse_match_jax(seed):
    ids, _ = _ids_2d(seed=seed)
    js, jo, jo2 = J.slot_sorted_ids(jnp.asarray(ids))
    ts, to, to2 = T.slot_sorted_ids(torch.from_numpy(ids))
    for got, want in ((ts, js), (to, jo), (to2, jo2)):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    flat = ids.reshape(-1)
    np.testing.assert_array_equal(flat[to.numpy()], ts.numpy())  # order is the permutation
    inv = T.slot_sorted_inverse(to2)
    np.testing.assert_array_equal(inv.numpy(), np.asarray(J.slot_sorted_inverse(jo2)))
    np.testing.assert_array_equal(ts.numpy()[inv.numpy()], flat)


def test_dedup_segment_sum_matches_jax():
    ids, rows = _ids_2d(b=60)
    flat = ids.reshape(-1)
    grads = np.random.default_rng(3).normal(size=(flat.size, 5)).astype(np.float32)
    ju, js, jv = J.dedup_segment_sum(jnp.asarray(flat), jnp.asarray(grads), rows)
    tu, ts, tv = T.dedup_segment_sum(torch.from_numpy(flat), torch.from_numpy(grads), rows)
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))  # ids, then sentinels rows + k
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert tu.numpy()[-1] == rows + flat.size - 1
    # both sum each id's grads in stable sorted order, one by one
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


# ---------------------------------------------------------- Adagrad update
@pytest.mark.parametrize("dim", [17, 1])
def test_sorted_update_reference_matches_sparse_adagrad(dim):
    table, acc, ids, grads = _stream(dim=dim)
    lr, eps = 0.05, 1e-8
    rows = table.shape[0]
    uids, gsum, _ = J.dedup_segment_sum(jnp.asarray(ids), jnp.asarray(grads), rows)
    jt, jst = J.sparse_adagrad(eps=eps).apply(jnp.asarray(table), {"acc": jnp.asarray(acc)},
                                              uids, gsum, jnp.asarray(0), lr)
    t, a = _port_update(table, acc, ids, grads, lr, eps)
    np.testing.assert_allclose(t, np.asarray(jt), **F32_TOL)
    np.testing.assert_allclose(a, np.asarray(jst["acc"]), **F32_TOL)
    untouched = np.setdiff1d(np.arange(rows), ids)
    np.testing.assert_array_equal(t[untouched], table[untouched])
    np.testing.assert_array_equal(a[untouched], acc[untouched])


@pytest.mark.parametrize("grad_dtype", ["f32", "bf16"])
def test_sorted_update_reference_matches_packed_tpu_kernel(monkeypatch, grad_dtype):
    """The TPU kernel in interpret mode on its packed layout, the raw sorted
    stream with duplicates and sentinels, R = 2,048 and d = 17."""
    monkeypatch.setattr(pallas_update, "_INTERPRET", True)
    bf16 = grad_dtype == "bf16"
    table, acc, ids, grads = _stream(bf16_grads=bf16)
    lr, eps = 0.05, 1e-8
    jg = jnp.asarray(grads, jnp.bfloat16 if bf16 else jnp.float32)
    tp, ap = jax.jit(lambda t, a: pallas_update.sorted_adagrad_update_packed(
        t, a, jnp.asarray(ids), jg, lr, eps))(pallas_gather.pack(jnp.asarray(table)),
                                              pallas_gather.pack(jnp.asarray(acc)))
    t, a = _port_update(table, acc, ids, grads, lr, eps, bf16_grads=bf16)
    np.testing.assert_allclose(t, np.asarray(pallas_gather.unpack(tp, 17)), **TABLE_TOL)
    np.testing.assert_allclose(a, np.asarray(pallas_gather.unpack(ap, 17)), **ACC_TOL)
    untouched = np.setdiff1d(np.arange(table.shape[0]), ids)
    np.testing.assert_array_equal(t[untouched], table[untouched])
    np.testing.assert_array_equal(a[untouched], acc[untouched])


def test_sorted_update_reference_matches_2d_tpu_kernel_on_dim1(monkeypatch):
    """A dim-1 table: the port's [R] layout against the TPU kernel's 2-D
    layout at width 1."""
    monkeypatch.setattr(pallas_update, "_INTERPRET", True)
    table, acc, ids, grads = _stream(dim=1)
    lr, eps = 0.05, 1e-8
    jt, ja = jax.jit(lambda t, a: pallas_update.sorted_adagrad_update(
        t, a, jnp.asarray(ids), jnp.asarray(grads)[:, None], lr, eps))(
        jnp.asarray(table)[:, None], jnp.asarray(acc)[:, None])
    t, a = _port_update(table, acc, ids, grads, lr, eps)
    np.testing.assert_allclose(t, np.asarray(jt)[:, 0], **TABLE_TOL)
    np.testing.assert_allclose(a, np.asarray(ja)[:, 0], **ACC_TOL)


def test_update_kernel_entry_rejects_devices_without_a_kernel():
    t = torch.empty((4, 3), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        sorted_adagrad_update(t, t, torch.empty((2,), dtype=torch.int32, device="meta"),
                              torch.empty((2, 3), device="meta"), _lr(0.1), 1e-8)


@pytest.mark.parametrize("dim", [9, 17, 1])
def test_apply_updates_matches_jax(dim):
    """The port's route (per-slot sort, grad permute, sorted update) in place
    against the JAX package's apply_updates on the CPU (dedup + sparse apply);
    a dim-1 table is [R] with [N] grads in both."""
    ids, rows = _ids_2d(b=50)
    rows_alloc = 1024
    rng = np.random.default_rng(5)
    grads = rng.normal(size=(ids.size, dim)).astype(np.float32)
    table = rng.normal(size=(rows_alloc, dim)).astype(np.float32)
    lr = 0.01
    opt = T.get_sparse_optimizer("adagrad")
    shape = (rows_alloc,) if dim == 1 else (rows_alloc, dim)
    t = torch.tensor(table.reshape(shape))
    st = opt.init(rows_alloc, dim)
    g = torch.from_numpy(grads.reshape(-1) if dim == 1 else grads)
    t2, st2 = T.apply_updates(opt, t, st, torch.from_numpy(ids), g, _step(0), _lr(lr))
    assert t2 is t and st2["acc"] is st["acc"] and st["acc"].shape == shape  # in place
    jt, jst = J.apply_updates(J.sparse_adagrad(), jnp.asarray(table.reshape(shape)),
                              J.sparse_adagrad().init(rows_alloc, dim), jnp.asarray(ids.reshape(-1)),
                              jnp.asarray(g.numpy()), jnp.asarray(0), lr)
    got_t, got_a = t.numpy().reshape(rows_alloc, dim), st["acc"].numpy().reshape(rows_alloc, dim)
    np.testing.assert_allclose(got_t, np.asarray(jt).reshape(rows_alloc, dim), **F32_TOL)
    np.testing.assert_allclose(got_a, np.asarray(jst["acc"]).reshape(rows_alloc, dim), **F32_TOL)
    untouched = np.setdiff1d(np.arange(rows_alloc), ids)
    np.testing.assert_array_equal(got_t[untouched], table[untouched])


@pytest.mark.parametrize("name", ["adam", "adam_dense"])
def test_sparse_adam_is_not_ported_yet(name):
    """Named for the time before lazy and dense Adam were ported: now
    ``get_sparse_optimizer`` returns them, with their hyperparameters and
    the JAX package's zero moments."""
    opt = T.get_sparse_optimizer(name, b1=0.8)
    jopt = J.get_sparse_optimizer(name, b1=0.8)
    assert opt.name == jopt.name == name
    assert opt.hyper == {"b1": 0.8, "b2": B2, "eps": EPS}
    for dim, shape in ((4, (10, 4)), (1, (10,))):
        st = opt.init(10, dim)
        assert sorted(st) == sorted(jopt.init(10, dim)) == ["m", "v"]
        assert all(t.shape == shape and t.dtype == torch.float32 and not t.any() for t in st.values())


# ------------------------------------------------------------- lazy Adam
def _adam_stream(dim, bf16_grads, seed=11):
    """``_stream`` with moments, and one id (rows - 10, outside the random
    ids) touched twice with grads x and -x: its sum is exactly 0."""
    table, _, ids, grads = _stream(dim=dim, seed=seed, bf16_grads=bf16_grads)
    rows = table.shape[0]
    rng = np.random.default_rng(seed + 1)
    m = (rng.normal(size=table.shape) * 0.1).astype(np.float32)
    v = (np.abs(rng.normal(size=table.shape)) * 0.01).astype(np.float32)
    ids = np.concatenate([ids[:-2], [rows - 10, rows - 10], ids[-2:]]).astype(np.int32)
    x = grads[:1]
    grads = np.concatenate([grads[:-2], x, -x, grads[-2:]])
    return table, m, v, ids, grads


def _port_adam(table, m, v, ids, grads, lr, step, bf16_grads):
    t, mm, vv = (torch.tensor(a) for a in (table, m, v))
    g = torch.tensor(grads)
    if bf16_grads:
        g = g.to(torch.bfloat16)
    before = sorted_adam_update.launches
    sorted_adam_update(t, mm, vv, torch.tensor(ids), g, adam_scalars(_lr(lr), _step(step), B1, B2),
                       B1, B2, EPS)
    assert sorted_adam_update.launches == before  # the CPU takes the plain version
    return t.numpy(), mm.numpy(), vv.numpy()


def _check_lazy(got, start, ids):
    """Untouched rows keep their bits; the zero-sum id's moments decay."""
    rows = start[0].shape[0]
    untouched = np.setdiff1d(np.arange(rows), ids)
    z = rows - 10
    for g, s0 in zip(got, start):
        np.testing.assert_array_equal(g[untouched], s0[untouched])
    np.testing.assert_array_equal(got[1][z], np.float32(B1) * start[1][z])
    np.testing.assert_array_equal(got[2][z], np.float32(B2) * start[2][z])


@pytest.mark.parametrize("step", [0, 5])
@pytest.mark.parametrize("grad_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("dim", [16, 17, 1])
def test_sorted_adam_reference_matches_sparse_adam(dim, grad_dtype, step):
    bf16 = grad_dtype == "bf16"
    table, m, v, ids, grads = _adam_stream(dim, bf16)
    lr = 0.01
    uids, gsum, _ = J.dedup_segment_sum(jnp.asarray(ids), jnp.asarray(grads), table.shape[0])
    jt, jst = J.sparse_adam(B1, B2, EPS).apply(
        jnp.asarray(table), {"m": jnp.asarray(m), "v": jnp.asarray(v)}, uids, gsum, jnp.asarray(step), lr)
    got = _port_adam(table, m, v, ids, grads, lr, step, bf16)
    for g, w in zip(got, (jt, jst["m"], jst["v"])):
        np.testing.assert_allclose(g, np.asarray(w), **F32_TOL)
    _check_lazy(got, (table, m, v), ids)


@pytest.mark.parametrize("grad_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("dim", [16, 17])
def test_sorted_adam_reference_matches_packed_tpu_kernel(monkeypatch, dim, grad_dtype):
    """The TPU lazy-Adam kernel in interpret mode on its packed layout: the
    raw sorted stream with duplicates, the zero-sum id and sentinels."""
    monkeypatch.setattr(pallas_update, "_INTERPRET", True)
    bf16 = grad_dtype == "bf16"
    table, m, v, ids, grads = _adam_stream(dim, bf16, seed=13)
    lr, step = 0.01, 3
    jg = jnp.asarray(grads, jnp.bfloat16 if bf16 else jnp.float32)
    outs = jax.jit(lambda t, a, b: pallas_update.sorted_adam_update_packed(
        t, a, b, jnp.asarray(ids), jg, lr, jnp.asarray(step), B1, B2, EPS))(
        *(pallas_gather.pack(jnp.asarray(x)) for x in (table, m, v)))
    got = _port_adam(table, m, v, ids, grads, lr, step, bf16)
    for g, w in zip(got, outs):
        np.testing.assert_allclose(g, np.asarray(pallas_gather.unpack(w, dim)), **ADAM_KERNEL_TOL)
    _check_lazy(got, (table, m, v), ids)


@pytest.mark.parametrize("name", ["adam", "adam_dense"])
@pytest.mark.parametrize("dim", [9, 17, 1])
def test_apply_updates_adam_matches_jax(dim, name):
    """The port's routes in place against the JAX package's apply_updates on
    the CPU from one mid-training state (moments not zero) at step 3: lazy
    Adam (sort, permute, sorted update) keeps the untouched rows' bits, dense
    Adam (dense grad, full-table Adam) decays them."""
    ids, _ = _ids_2d(b=50)
    rows_alloc, lr, step = 1024, 0.01, 3
    rng = np.random.default_rng(17)
    shape = (rows_alloc,) if dim == 1 else (rows_alloc, dim)
    table = rng.normal(size=shape).astype(np.float32)
    m = (rng.normal(size=shape) * 0.1).astype(np.float32)
    v = (np.abs(rng.normal(size=shape)) * 0.01).astype(np.float32)
    grads = rng.normal(size=(ids.size, *shape[1:])).astype(np.float32)
    opt = T.get_sparse_optimizer(name)
    t, st = torch.tensor(table), {"m": torch.tensor(m), "v": torch.tensor(v)}
    st_in = dict(st)
    t2, st2 = T.apply_updates(opt, t, st, torch.from_numpy(ids), torch.from_numpy(grads), _step(step),
                              _lr(lr))
    assert t2 is t and st2 is st and all(st[k] is st_in[k] for k in st)  # in place
    jt, jst = J.apply_updates(J.get_sparse_optimizer(name), jnp.asarray(table),
                              {"m": jnp.asarray(m), "v": jnp.asarray(v)}, jnp.asarray(ids.reshape(-1)),
                              jnp.asarray(grads), jnp.asarray(step), lr)
    got = (t.numpy(), st["m"].numpy(), st["v"].numpy())
    for g, w in zip(got, (jt, jst["m"], jst["v"])):
        np.testing.assert_allclose(g, np.asarray(w), **F32_TOL)
    untouched = np.setdiff1d(np.arange(rows_alloc), ids)
    assert untouched.size > 0
    if name == "adam":
        for g, s0 in zip(got, (table, m, v)):
            np.testing.assert_array_equal(g[untouched], s0[untouched])
    else:  # the dense route decays every row: a zero grad still moves m, v and the table
        np.testing.assert_allclose(got[1][untouched], np.float32(B1) * m[untouched], **F32_TOL)
        np.testing.assert_allclose(got[2][untouched], np.float32(B2) * v[untouched], **F32_TOL)
        assert np.all(got[0][untouched] != table[untouched])


def test_adam_kernel_entry_rejects_devices_without_a_kernel():
    t = torch.empty((4, 3), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        sorted_adam_update(t, t, t, torch.empty((2,), dtype=torch.int32, device="meta"),
                           torch.empty((2, 3), device="meta"), torch.tensor([0.1, 0.1, 0.001]), B1, B2, EPS)


# ---------------------------------------------------------- dense optimizers
@pytest.mark.parametrize("name", ["adam", "adagrad", "sgd"])
def test_dense_optimizers_match_optax(name):
    rng = np.random.default_rng(7)
    params = {"a": rng.normal(size=(5, 3)).astype(np.float32),
              "b": rng.normal(size=(4,)).astype(np.float32)}
    lr = 1e-2
    tx = {"adam": optax.adam, "adagrad": optax.adagrad, "sgd": optax.sgd}[name](lr)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js = tx.init(jp)
    opt = TO.get_dense_optimizer(name)
    tp = [torch.tensor(params[k]) for k in sorted(params)]
    ts = opt.init(tp)
    for _ in range(4):
        g = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in params.items()}
        upd, js = tx.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, upd)
        ts = opt.update(tp, [torch.tensor(g[k]) for k in sorted(g)], ts, lr)
    for k, t in zip(sorted(params), tp):
        np.testing.assert_allclose(t.numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-7)
    if name == "adam":
        assert int(ts["count"]) == int(js[0].count) == 4
        for k, mu, nu in zip(sorted(params), ts["mu"], ts["nu"]):
            np.testing.assert_allclose(mu.numpy(), np.asarray(js[0].mu[k]), rtol=1e-6, atol=1e-8)
            np.testing.assert_allclose(nu.numpy(), np.asarray(js[0].nu[k]), rtol=1e-6, atol=1e-8)
