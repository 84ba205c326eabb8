"""The port's DLRM-DCNv2 and its multi-hot slots on the CPU, against the plain
f32 reference of ``tests/plain_dlrm_dcnv2.py`` (the JAX package has no such
model), on seeded random weights at a small size: 4 slots of 300-450 rows
and dim 8, hotness (3, 1, 7, 2), 13 dense features, bottom (16, 8), two
cross layers of rank 6 over x0 of 40, top (32, 16), batch 64. Ids repeat
within a bag, across a slot's hot columns and across examples.

Tolerances:
* f32: the port runs the reference's math with other summation orders (the
  bag sums in bag order against ``sum``; the products' blocking; ``addcmul``
  against a product and an add): logits, losses, grads and three steps'
  parameters, accumulators and table to rtol 1e-5 (atol 1e-6 for values
  near 0, which carry the absolute error of their larger terms).
* bf16 (``compute_dtype``): every GEMM operand, bag sum and layer output is
  rounded to bf16 (2^-9 relative), about 20 roundings deep from the tables
  to the logit; the repo's bf16 rule for logits holds, 0.03 * max |logit| +
  1e-3, and BCE is 1-Lipschitz in each logit, so the mean loss takes the
  same bound. A gradient is a batch sum of terms of both signs (p - y of
  either sign at logits near 0), 5-20 times smaller than the sum of their
  magnitudes here, so the roundings' 1-2% on each term become more of the
  sum: over seeds 0-5 the whole gradient (every dense leaf and the pooled
  rows) lies 0.6-6.7% of its norm from the reference's, one leaf up to 15%
  of its own. So the bf16 gradient, and the change of the state over three
  steps (Adagrad's steps are the gradient's, scaled per element), are held
  as whole vectors to 10% of the reference's norm; the f32 cases hold each
  element.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import plain_dlrm_dcnv2 as plain
from recmodels_tpu_torch.data.schema import MultiHotSpec, Schema, criteo_schema, slot_spec
from recmodels_tpu_torch.embedding import bag as bag_mod
from recmodels_tpu_torch.embedding.bag import bag_gather, bag_gather_reference
from recmodels_tpu_torch.embedding.collection import EmbeddingCollection
from recmodels_tpu_torch.embedding.gather import gather_rows_reference
from recmodels_tpu_torch.embedding import optim as optim_mod
from recmodels_tpu_torch.embedding.optim import (
    apply_bag_updates, apply_sorted_updates, bag_sorted_ids, get_sparse_optimizer, sparse_adagrad,
)
from recmodels_tpu_torch.embedding.update import adam_scalars, sorted_adagrad_update, sorted_adam_update
from recmodels_tpu_torch.models import build_model
from recmodels_tpu_torch.serve import Predictor
from recmodels_tpu_torch.train import engine as engine_mod
from recmodels_tpu_torch.train.engine import Engine
from recmodels_tpu_torch.utils import profiling, tree

HOT = (3, 1, 7, 2)
VOCABS = (300, 350, 400, 450)
DIM = 8
B = 64
LR = 0.005
F32_TOL = dict(rtol=1e-5, atol=1e-6)


def _schema(hotness=HOT) -> Schema:
    return Schema(n_dense=13, slots=tuple(slot_spec(f"c{i}", v, DIM, h)
                                          for i, (v, h) in enumerate(zip(VOCABS, hotness))))


def _engine(dtype=torch.float32, hotness=HOT) -> Engine:
    model = build_model("dlrm_dcnv2", _schema(hotness), bottom=(16, DIM), top=(32, 16), n_cross=2, low_rank=6,
                        compute_dtype=dtype)
    return Engine(model, dense_optimizer="adagrad", sparse_optimizer="adagrad", dense_lr=LR, emb_lr=LR)


def _state(engine: Engine, seed: int = 0):
    """A state whose every parameter is live (the cross biases drawn too)."""
    state = engine.init(seed=seed, device="cpu")
    g = torch.Generator().manual_seed(seed + 100)
    for layer in state.dense_params["cross"]:
        layer["b"].copy_(torch.randn(layer["b"].shape, generator=g) * 0.1)
    for layer in state.dense_params["top"] + state.dense_params["bottom"]:
        layer["b"].copy_(torch.randn(layer["b"].shape, generator=g) * 0.05)
    return state


def _batch(schema: Schema, seed: int):
    """Slot-local ids [B, n_ids] with repeats: each slot draws from its 40
    lowest ids, and bag positions repeat the bag's first id a third of the
    time, so ids repeat within a bag, across a slot's columns and across
    examples."""
    g = torch.Generator().manual_seed(seed)
    cols = []
    for s in schema.id_slots:
        cols.append(torch.randint(0, 40, (B,), generator=g))
    ids = torch.stack(cols, dim=1)
    c = 0
    for h in schema.hotness:
        for j in range(c + 1, c + h):
            same = torch.rand(B, generator=g) < 1 / 3
            ids[:, j] = torch.where(same, ids[:, c], ids[:, j])
        c += h
    dense = torch.log1p(torch.rand((B, schema.n_dense), generator=g) * 50)
    labels = (torch.rand(B, generator=g) < 0.3).float()
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
    bound = 0.03 * float(want.abs().max()) + 1e-3
    assert float((got.float() - want.float()).abs().max()) <= bound


def _vector_close(got: list, want: list, share: float = 0.10):
    """The concatenated vectors within ``share`` of the reference's norm."""
    g = torch.cat([t.detach().double().reshape(-1) for t in got])
    w = torch.cat([t.detach().double().reshape(-1) for t in want])
    assert float((g - w).norm()) <= share * float(w.norm())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_logits_match_the_plain_reference(dtype):
    engine = _engine(dtype)
    state = _state(engine)
    dense, ids, _ = _batch(engine.model.schema, 1)
    got = engine.logits(state, dense, ids)
    want = plain.logits(state.dense_params, _table(state), dense, _global_ids(engine, ids), HOT)
    assert got.shape == (B,) and got.dtype == torch.float32
    if dtype == torch.float32:
        _close(got, want)
    else:
        _bf16_close(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_loss_and_its_dense_and_pooled_grads_match(dtype):
    """``Engine._grads``: the loss, the dense grads and the pooled rows'
    grads [B, n_slots, d] against autograd of the plain model."""
    engine = _engine(dtype)
    state = _state(engine)
    dense, ids, labels = _batch(engine.model.schema, 2)
    loss, _, _, _, g_dense, g_rows = engine._grads(state, dense, ids, labels)
    (g_pooled,) = g_rows["emb"].values()
    params = {k: [{n: t.clone().requires_grad_(True) for n, t in layer.items()} for layer in v]
              for k, v in state.dense_params.items()}
    e = plain.pooled(_table(state), _global_ids(engine, ids), HOT).requires_grad_(True)
    want = torch.nn.functional.binary_cross_entropy_with_logits(plain.logits_from_pooled(params, dense, e), labels)
    want_grads = torch.autograd.grad(want, plain.leaves(params) + [e])
    assert g_pooled.shape == (B, len(HOT), DIM)
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
        state.dense_params, table0, [(d, _global_ids(engine, i), lab) for d, i, lab in batches], HOT, LR, LR)
    start = [p.clone() for p in tree.leaves(state.dense_params)]
    losses = [float(engine.train_step(state, *bt)[1]["loss"]) for bt in batches]
    assert int(state.step) == 3
    touched = torch.zeros(table0.shape[0], dtype=torch.bool)
    for _, i, _ in batches:
        touched[_global_ids(engine, i).long().reshape(-1)] = True
    assert torch.equal(_table(state)[~touched], table0[~touched])
    assert bool((_acc(state)[~touched] == 0.1).all())
    got_leaves = list(tree.leaves(state.dense_params))
    if dtype == torch.float32:
        np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
        for got, want in zip(got_leaves, plain.leaves(want_params)):
            _close(got, want)
        for got, want in zip(state.dense_opt["sum_of_squares"], want_sos):
            _close(got, want)
        _close(_table(state), want_table)
        _close(_acc(state), want_acc)
    else:
        assert max(abs(a - b) for a, b in zip(losses, want_losses)) <= 0.03 * 2 + 1e-3
        _vector_close([g - p0 for g, p0 in zip(got_leaves, start)] + [_table(state) - table0],
                      [w - p0 for w, p0 in zip(plain.leaves(want_params), start)] + [want_table - table0])


def test_plain_bag_path_is_gather_then_sum():
    """The bag gather's CPU path: each bag's rows gathered, then summed in
    bag order in f32, cast once: bit for bit a loop over the gathered rows;
    within f32 rounding of ``sum``; the bf16 output the cast of the f32."""
    g = torch.Generator().manual_seed(3)
    table = torch.randn((500, DIM), generator=g)
    ids = torch.randint(0, 500, (B, sum(HOT)), generator=g, dtype=torch.int32)
    ids[:, 2] = ids[:, 0]  # a repeat inside a bag
    got = bag_gather(table, ids, HOT, torch.float32)
    rows = gather_rows_reference(table, ids, torch.float32)
    loop, c = [], 0
    for h in HOT:
        acc = rows[:, c]
        for j in range(c + 1, c + h):
            acc = acc + rows[:, j]
        loop.append(acc)
        c += h
    assert torch.equal(got, torch.stack(loop, dim=1))
    sums = torch.stack([r.sum(dim=1) for r in torch.split(rows, HOT, dim=1)], dim=1)
    _close(got, sums)
    assert torch.equal(bag_gather(table, ids, HOT, torch.bfloat16), got.to(torch.bfloat16))
    assert torch.equal(bag_gather_reference(table, ids, HOT, torch.float32), got)
    with pytest.raises(ValueError, match="bags"):
        bag_gather(table, ids[:, :-1], HOT, torch.float32)


def test_bag_sort_gives_each_row_one_run():
    """One stable sort of the whole batch: ascending ids, each row's
    positions together in b-major order, and each position's bag, int32
    (the update kernels' index)."""
    engine = _engine()
    _, ids, _ = _batch(engine.model.schema, 4)
    gids = _global_ids(engine, ids)
    sorted_ids, bags = bag_sorted_ids(gids, HOT)
    assert sorted_ids.dtype == bags.dtype == torch.int32
    assert torch.equal(sorted_ids, torch.sort(gids.reshape(-1))[0])
    assert bool((sorted_ids[1:] >= sorted_ids[:-1]).all())
    slot_of = torch.tensor(engine.model.schema.id_slots)
    flat = gids.reshape(-1)
    order = torch.sort(flat, stable=True)[1]
    assert torch.equal(bags, ((order // gids.shape[1]) * len(HOT) + slot_of[order % gids.shape[1]]).int())
    starts = torch.ones_like(sorted_ids, dtype=torch.bool)
    starts[1:] = sorted_ids[1:] != sorted_ids[:-1]
    assert int(starts.sum()) == int(torch.unique(flat).numel())  # one run a row


def test_predictor_takes_bags_and_names_the_slot_of_a_bad_id():
    engine = _engine()
    state = _state(engine)
    dense, ids, _ = _batch(engine.model.schema, 5)
    pred = Predictor(engine, state, torch.device("cpu"), min_bucket=16)
    got = pred.predict_logits(dense[:37].numpy(), ids[:37].numpy())
    want = plain.logits(state.dense_params, _table(state), dense[:37], _global_ids(engine, ids[:37]), HOT)
    _close(torch.from_numpy(got), want)
    with pytest.raises(ValueError, match=r"ids must be \[B, 13\]"):
        pred.predict_logits(dense.numpy(), ids[:, :4].numpy())
    bad = ids.clone()
    bad[3, 9] = VOCABS[2]  # column 9 is slot 2's (columns 4-10)
    with pytest.raises(ValueError, match="outside slot 2's vocab"):
        pred.predict_logits(dense.numpy(), bad.numpy())


def test_one_hot_schemas_take_the_one_hot_path(monkeypatch):
    """With every hotness at 1 nothing of the bag path runs: the row gather
    and the per-slot sort, ids [B, n_slots] offset as before; the schema's
    fields are the JAX package's; a DeepFM step gives the bits of the same
    step on slots that are bags of one id; the pooled update route's counter
    does not move."""
    import dataclasses

    sch = criteo_schema(vocab_size=50, embed_dim=8)
    assert sch.hotness == (1,) * 26 and sch.n_ids == sch.n_slots == 26 and not sch.multi_hot
    assert set(dataclasses.asdict(sch)["slots"][0]) == {"name", "vocab_size", "embed_dim"}
    assert sch.id_slots == tuple(range(26))
    coll = EmbeddingCollection(sch)
    ids = torch.randint(0, 50, (16, 26), dtype=torch.int32)
    (gids,) = coll.group_row_ids(ids).values()
    assert torch.equal(gids, ids + torch.arange(26, dtype=torch.int32) * 50)
    calls = []
    monkeypatch.setattr(engine_mod, "bag_sorted_ids", lambda *a: calls.append("sort"))
    monkeypatch.setattr(bag_mod, "bag_gather_reference", lambda *a: calls.append("gather"))
    before = profiling.snapshot()["counters"].get("emb.bag_calls", 0)
    pooled_before = profiling.snapshot()["counters"].get("emb.bag_pooled_updates", 0)

    def run(schema):
        eng = Engine(build_model("deepfm", schema, hidden=(16,)))
        st = eng.init(seed=0, device="cpu")
        g = torch.Generator().manual_seed(7)
        batch = (torch.rand((16, 13), generator=g), torch.randint(0, 50, (16, 26), generator=g, dtype=torch.int32),
                 (torch.rand(16, generator=g) < 0.5).float())
        eng.train_step(st, *batch)
        return [*tree.leaves(st.dense_params), *st.emb_params["emb"].values()]

    # bags of one id each: the one-hot path too
    explicit = Schema(n_dense=13, slots=tuple(MultiHotSpec(s.name, s.vocab_size, s.embed_dim, 1) for s in sch.slots))
    for a, b in zip(run(sch), run(explicit)):
        assert torch.equal(a, b)
    assert calls == [] and profiling.snapshot()["counters"].get("emb.bag_calls", 0) == before
    assert profiling.snapshot()["counters"].get("emb.bag_pooled_updates", 0) == pooled_before


def _pooled_stream(dim: int, grad_dtype: torch.dtype, seed: int = 3):
    """A multi-hot group's sorted stream on the CPU: (table [R, dim] or [R],
    sorted ids [N] int32 with a sentinel tail, pooled grads [P, dim] or [P]
    in ``grad_dtype``, bags [N] int32)."""
    engine = _engine()
    _, ids, _ = _batch(engine.model.schema, seed)
    sorted_ids, bags = bag_sorted_ids(_global_ids(engine, ids), HOT)
    rows = sum(VOCABS)
    sorted_ids[-2:] = torch.tensor([rows, rows + 5], dtype=torch.int32)
    g = torch.Generator().manual_seed(seed)
    row = () if dim == 1 else (dim,)
    table = torch.randn((rows, *row), generator=g)
    pooled = torch.randn((B * len(HOT), *row), generator=g).to(grad_dtype)
    return table, sorted_ids, pooled, bags


def _sparse_state(name: str, table: torch.Tensor):
    """A live optimizer state for ``table``: Adagrad's acc, Adam's m and v."""
    g = torch.Generator().manual_seed(9)
    if name == "adagrad":
        return {"acc": torch.rand(table.shape, generator=g) + 0.1}
    return {"m": torch.randn(table.shape, generator=g) * 0.1, "v": torch.rand(table.shape, generator=g) * 0.01}


def _sorted_update(name: str, table, state, sorted_ids, grads, grad_index=None):
    """The sorted-stream update of ``name`` at lr 0.05 (Adam at step 3)."""
    lr = torch.tensor(0.05)
    if name == "adagrad":
        sorted_adagrad_update(table, state["acc"], sorted_ids, grads, lr, 1e-8, grad_index)
    else:
        scalars = adam_scalars(lr, torch.tensor(3, dtype=torch.int32), 0.9, 0.999)
        sorted_adam_update(table, state["m"], state["v"], sorted_ids, grads, scalars, 0.9, 0.999, 1e-8, grad_index)


@pytest.mark.parametrize("name", ["adagrad", "adam"])
@pytest.mark.parametrize("dim", [8, 1])
@pytest.mark.parametrize("grad_dtype", [torch.bfloat16, torch.float32])
def test_pooled_plain_updates_equal_the_expanded_stream(name, dim, grad_dtype):
    """The plain versions take pooled grads through ``grad_index`` as the
    expanded stream: bit for bit the update of the pooled rows expanded
    along the bags (the reference the kernels are held to on the card)."""
    table, sorted_ids, pooled, bags = _pooled_stream(dim, grad_dtype)
    state = _sparse_state(name, table)
    want_t, want_s = table.clone(), {k: v.clone() for k, v in state.items()}
    _sorted_update(name, want_t, want_s, sorted_ids, torch.index_select(pooled, 0, bags.long()))
    _sorted_update(name, table, state, sorted_ids, pooled, bags)
    assert not torch.equal(table, _pooled_stream(dim, grad_dtype)[0])  # the update moved rows
    assert torch.equal(table, want_t) and all(torch.equal(state[k], want_s[k]) for k in state)


@pytest.mark.parametrize("name", ["adagrad", "adam"])
@pytest.mark.parametrize("bad,error", [
    ("int64", TypeError), ("short", ValueError), ("2-d", ValueError), ("rows", ValueError),
])
def test_a_wrong_grad_index_raises(name, bad, error):
    """A grad index that is not int32 [N], or pooled grads whose rows do not
    fit the table, raise before anything is updated."""
    table, sorted_ids, pooled, bags = _pooled_stream(8, torch.bfloat16)
    state = _sparse_state(name, table)
    before = table.clone()
    index = {"int64": bags.long(), "short": bags[:-1], "2-d": bags[None]}.get(bad, bags)
    grads = pooled[:, :7] if bad == "rows" else pooled
    with pytest.raises(error):
        _sorted_update(name, table, state, sorted_ids, grads, index)
    assert torch.equal(table, before)


@pytest.mark.parametrize("name", ["adagrad", "adam", "adam_dense"])
def test_cpu_tables_and_dense_adam_expand_the_pooled_grads(monkeypatch, name):
    """On a CPU table every optimizer takes the pooled grads expanded along
    the sorted bags (dense Adam on any device): ``apply_sorted_updates``
    gets the expanded stream and no index, the pooled route's counter does
    not move, and the state is the old route's bit for bit."""
    table, _, _, _ = _pooled_stream(8, torch.float32)
    engine = _engine()
    _, ids, _ = _batch(engine.model.schema, 8)
    gids = _global_ids(engine, ids)
    pooled = torch.randn((B, len(HOT), DIM), generator=torch.Generator().manual_seed(4))
    opt = get_sparse_optimizer(name)
    state = opt.init(table.shape[0], DIM) if name == "adam_dense" else _sparse_state(name, table)
    old_t, old_s = table.clone(), {k: v.clone() for k, v in state.items()}
    step, lr = torch.tensor(2, dtype=torch.int32), torch.tensor(0.05)
    sorted_ids, bags = bag_sorted_ids(gids, HOT)
    apply_sorted_updates(opt, old_t, old_s, sorted_ids,
                         torch.index_select(pooled.reshape(-1, DIM), 0, bags.long()), step, lr)
    seen = []
    real = optim_mod.apply_sorted_updates
    monkeypatch.setattr(optim_mod, "apply_sorted_updates",
                        lambda *a, grad_index=None: seen.append((a[4].shape, grad_index)) or real(*a))
    before = profiling.snapshot()["counters"].get("emb.bag_pooled_updates", 0)
    apply_bag_updates(opt, table, state, gids, pooled, HOT, step, lr)
    assert seen == [((B * sum(HOT), DIM), None)]
    assert profiling.snapshot()["counters"].get("emb.bag_pooled_updates", 0) == before
    assert torch.equal(table, old_t) and all(torch.equal(state[k], old_s[k]) for k in state)


def test_dense_adam_refuses_a_grad_index():
    table, sorted_ids, pooled, bags = _pooled_stream(8, torch.float32)
    opt = get_sparse_optimizer("adam_dense")
    with pytest.raises(ValueError, match="dense Adam"):
        apply_sorted_updates(opt, table, opt.init(table.shape[0], 8), sorted_ids, pooled,
                             torch.tensor(0, dtype=torch.int32), torch.tensor(0.05), grad_index=bags)


def test_bag_gather_counts_its_lookups():
    engine = _engine()
    state = _state(engine)
    dense, ids, _ = _batch(engine.model.schema, 6)
    before = profiling.snapshot()["counters"]
    engine.logits(state, dense, ids)
    after = profiling.snapshot()["counters"]
    assert after["emb.bag_lookups"] - before.get("emb.bag_lookups", 0) == B * sum(HOT)
    assert after["emb.bag_calls"] - before.get("emb.bag_calls", 0) == 1


def test_captured_scan_on_the_cpu_equals_steps():
    """``jit_train_scan`` (no capture on the CPU) equals K ``train_step``s
    bit for bit."""
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


def test_sharded_tables_and_the_tsv_source_refuse_multi_hot(tmp_path):
    from recmodels_tpu_torch.data.criteo import CriteoTSVSource
    from recmodels_tpu_torch.parallel.mesh import Mesh
    from recmodels_tpu_torch.parallel.sharded_embedding import ShardedTables

    sch = criteo_schema(vocab_size=50, embed_dim=8, hotness=(2,) + (1,) * 25)
    assert sch.multi_hot and sch.n_ids == 27
    with pytest.raises(NotImplementedError, match="multi-hot"):
        ShardedTables({"emb": EmbeddingCollection(sch)}, sparse_adagrad(), Mesh(None, 2, 0, torch.device("cpu")))
    path = tmp_path / "day.tsv"
    path.write_text("")
    with pytest.raises(NotImplementedError, match="one id a slot"):
        CriteoTSVSource(str(path), sch, 8)


def test_constructor_checks_the_bottom_width():
    with pytest.raises(ValueError, match="embedding dim"):
        build_model("dlrm_dcnv2", _schema(), bottom=(16, 12))
