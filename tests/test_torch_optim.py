"""The port's optimizers on the CPU against the JAX package.

* stream prep (``slot_sorted_ids``, its inverse, ``dedup_segment_sum``)
  against ``recmodels_tpu.embedding.optim``, exactly;
* the sorted Adagrad update's plain version against JAX's
  ``sparse_adagrad().apply`` and against the TPU kernel
  ``pallas_update.sorted_adagrad_update_packed`` (and, for a dim-1 table,
  ``sorted_adagrad_update``) run in interpret mode;
* ``apply_updates`` (sort, permute, sorted update) against JAX's;
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
from recmodels_tpu_torch.embedding.update import sorted_adagrad_update
from recmodels_tpu_torch.train import optim as TO

# the TPU kernel's own tolerances against sparse Adagrad
# (tests/test_tpu_kernels.py): its duplicate sums run in another order and
# the compiler may contract acc + g*g into one FMA
TABLE_TOL = dict(rtol=1e-4, atol=1e-6)
ACC_TOL = dict(rtol=3e-4, atol=1e-5)
# f32 elementwise optimizer math in another association or with FMA: ulps
F32_TOL = dict(rtol=1e-6, atol=1e-7)


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
    sorted_adagrad_update(t, a, torch.tensor(ids), g, lr, eps)
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
                              torch.empty((2, 3), device="meta"), 0.1, 1e-8)


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
    t2, st2 = T.apply_updates(opt, t, st, torch.from_numpy(ids), g, lr)
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
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 2 #7"):
        T.get_sparse_optimizer(name)


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
        assert ts["count"] == int(js[0].count) == 4
        for k, mu, nu in zip(sorted(params), ts["mu"], ts["nu"]):
            np.testing.assert_allclose(mu.numpy(), np.asarray(js[0].mu[k]), rtol=1e-6, atol=1e-8)
            np.testing.assert_allclose(nu.numpy(), np.asarray(js[0].nu[k]), rtol=1e-6, atol=1e-8)
