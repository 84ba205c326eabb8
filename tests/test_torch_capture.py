"""The compiled step and scorer on the CPU: what ``Engine.jit_train_step``,
``jit_train_scan`` and the bucketed ``Predictor`` need from the code beneath
them, held against the previous formulas and against the JAX package.

* The dense optimizers update their state in place (every state tensor keeps
  its address over three steps) and give the previous, out-of-place
  formulas' bits; ``TrainState.step`` and Adam's ``count`` are 0-d int32
  tensors advanced in place, as JAX keeps them.
* The bias corrections computed on the tensors' device are within one f32
  ulp of JAX's ``1 - b**t`` for t from 1 to 10^5; the sparse updates' plain
  versions read lr and ``[lr, bc1, bc2]`` from their tensors.
* On a CPU state ``jit_train_step`` runs the static-buffer code without
  capture: bit for bit ``train_step`` on small slice-2 and slice-3 engines
  and on AFM,
  and ``jit_train_scan``'s losses ``train_scan``'s; a second state or batch
  shape does not write into the first state.
* Groups that share one ids tensor (slice 3's ``emb`` and ``wide``) share
  one sort a step, with the per-group sort's bits.
* The port's Predictor pads to JAX's buckets: the same ``_bucket``; padded
  logits bit for bit the port's eager logits of the padded batch, and
  within the serving tolerance of JAX's Predictor and of the port's
  unpadded eager logits.

Tolerances: the padded Predictor against JAX's and against the unpadded
request, the serving tests' (f32 to rounding order, rtol 1e-5; bf16 the
repo's rule, 3% of the largest |logit| + 1e-3, ``tests/test_torch_serve.py``).
Everything else is bit for bit: the same operations in the same order on the
same device.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recmodels_tpu.data import SyntheticSource
from recmodels_tpu.models import build_model as jbuild_model
from recmodels_tpu.serve import Predictor as JPredictor
from recmodels_tpu.serve import export_model as jexport
from recmodels_tpu.serve import load_predictor as jload
from recmodels_tpu.train.engine import Engine as JEngine
from recmodels_tpu.train.loop import build_schema as jbuild_schema
from recmodels_tpu.utils.config import TrainConfig as JConfig
from recmodels_tpu_torch.embedding import optim as sparse_optim
from recmodels_tpu_torch.embedding.update import (
    adam_scalars, bias_corrections, device_constant, sorted_adagrad_update_reference,
    sorted_adam_update_reference,
)
from recmodels_tpu_torch.models import build_model
from recmodels_tpu_torch.serve import Predictor, load_predictor
from recmodels_tpu_torch.train import engine as engine_module
from recmodels_tpu_torch.train import optim as TO
from recmodels_tpu_torch.train.engine import Engine, LocalTables
from recmodels_tpu_torch.utils.config import TrainConfig, build_schema
from recmodels_tpu_torch.utils.tree import leaves

B1, B2, EPS = 0.9, 0.999, 1e-8
BATCH = 64
F32_TOL = dict(rtol=1e-5, atol=1e-5)


def _state_tensors(state):
    return [t for t in leaves(state) if isinstance(t, torch.Tensor)]


def _snapshot(state):
    return [t.clone() for t in _state_tensors(state)]


def _same_bits(state, snapshot) -> bool:
    return all(torch.equal(a, b) for a, b in zip(_state_tensors(state), snapshot))


# ------------------------------------------------------ dense optimizers
def _previous_update(name, params, grads, state, lr):
    """The dense optimizers as they were before they went in place (new
    lists of moments, a Python-int count, Python-float bias corrections),
    kept here as the bits to hold the in-place versions to."""
    if name == "adam":
        mu = torch._foreach_add(torch._foreach_mul(grads, 1.0 - B1), torch._foreach_mul(state["mu"], B1))
        nu = torch._foreach_add(torch._foreach_mul(torch._foreach_mul(grads, grads), 1.0 - B2),
                                torch._foreach_mul(state["nu"], B2))
        count = state["count"] + 1
        bc = [float(np.float32(1.0) - np.float32(b) ** np.float32(count)) for b in (B1, B2)]
        den = torch._foreach_sqrt(torch._foreach_div(nu, bc[1]))
        torch._foreach_add_(den, EPS)
        step = torch._foreach_div(torch._foreach_div(mu, bc[0]), den)
        torch._foreach_mul_(step, -lr)
        torch._foreach_add_(params, step)
        return {"count": count, "mu": mu, "nu": nu}
    if name == "adagrad":
        sos = torch._foreach_add(torch._foreach_mul(grads, grads), state["sum_of_squares"])
        for p, g, s in zip(params, grads, sos):
            p.add_(-lr * (torch.where(s > 0, torch.rsqrt(s + 1e-7), torch.zeros_like(s)) * g))
        return {"sum_of_squares": sos}
    torch._foreach_add_(params, torch._foreach_mul(grads, -lr))
    return state


@pytest.mark.parametrize("name", ["adam", "adagrad", "sgd"])
def test_dense_optimizers_in_place_keep_the_previous_bits(name):
    rng = np.random.default_rng(3)
    shapes = ((5, 3), (4,), (1,))
    start = [rng.normal(size=s).astype(np.float32) for s in shapes]
    opt = TO.get_dense_optimizer(name)
    params = [torch.tensor(p) for p in start]
    old_params = [torch.tensor(p) for p in start]
    state = opt.init(params)
    old_state = {k: (v if k != "count" else 0) for k, v in opt.init(old_params).items()}
    ptrs = [t.data_ptr() for t in params + _state_tensors(state)]
    lr = 1e-2
    for _ in range(3):
        grads = [torch.tensor(rng.normal(size=s).astype(np.float32)) for s in shapes]
        assert opt.update(params, grads, state, lr) is state
        old_state = _previous_update(name, old_params, grads, old_state, lr)
    assert [t.data_ptr() for t in params + _state_tensors(state)] == ptrs
    for got, want in zip(params, old_params):
        assert torch.equal(got, want)
    for k, v in state.items():
        if k == "count":
            assert int(v) == old_state[k] == 3
        else:
            assert all(torch.equal(a, b) for a, b in zip(v, old_state[k]))


def _tiny_engine(slice3: bool, bf16: bool = True):
    """Slice 2: CIN(32, 32), the fused wide column, sparse Adagrad. Slice 3
    at small widths: a three-layer CIN, ``fuse_wide=False`` (a dim-16 and a
    dim-1 table over one ids tensor), lazy Adam on both tables."""
    cin = (16, 16, 16) if slice3 else (32, 32)
    cfg = TrainConfig(model="xdeepfm", vocab_size=50, embed_dim=16, cin_sizes=cin, hidden=(32, 32),
                      bf16=bf16)
    schema = build_schema(cfg)
    kw = dict(sparse_optimizer="adam", fuse_wide=False) if slice3 else {}
    return Engine(build_model("xdeepfm", schema, **cfg.model_kwargs()), **kw), schema


def _batches(schema, n: int, batch: int = BATCH, seed: int = 1):
    it = iter(SyntheticSource(schema, batch_size=batch, seed=seed))
    return [tuple(torch.from_numpy(a) for a in (b.dense, b.ids, b.labels)) for b in
            (next(it) for _ in range(n))]


def test_step_and_adam_count_are_int32_tensors_advanced_in_place():
    eng, schema = _tiny_engine(slice3=False)
    state = eng.init(seed=0, device="cpu")
    step, count = state.step, state.dense_opt["count"]
    for t in (step, count):
        assert t.dtype == torch.int32 and t.shape == () and int(t) == 0
    for k, b in enumerate(_batches(schema, 2)):
        state, _ = eng.train_step(state, *b)
        assert state.step is step and state.dense_opt["count"] is count
        assert int(step) == int(count) == k + 1


@pytest.mark.parametrize("decay", [B1, B2])
def test_device_bias_corrections_within_an_ulp_of_jax(decay):
    """``bias_corrections`` on a 0-d int32 count, as the optimizers call it,
    against JAX's lazy Adam (``1 - b**t``, t f32) and optax
    (``1 - decay**count``, count int32)."""
    ts = np.unique(np.concatenate([np.arange(1, 1001), [100_000],
                                   np.random.default_rng(0).integers(1, 100_001, size=1000)]))
    jt = np.asarray(jax.jit(lambda t: 1.0 - decay ** t)(jnp.asarray(ts, jnp.float32)))
    jo = np.asarray(jax.jit(lambda c: 1 - decay ** c)(jnp.asarray(ts, jnp.int32)))
    decays = device_constant((decay,), torch.device("cpu"))
    got = np.array([bias_corrections(decays, torch.tensor(int(t), dtype=torch.int32)).item() for t in ts],
                   np.float32)
    for want in (jt, jo):
        assert want.dtype == np.float32
        ulps = np.abs(got.view(np.int32).astype(np.int64) - want.view(np.int32).astype(np.int64))
        assert ulps.max() <= 1, (ts[ulps.argmax()], ulps.max())


def test_adagrad_plain_version_reads_lr_from_its_tensor():
    rng = np.random.default_rng(5)
    table = rng.normal(size=(64, 4)).astype(np.float32)
    ids = torch.tensor(np.sort(rng.integers(0, 64, size=40)).astype(np.int32))
    grads = torch.tensor(rng.normal(size=(40, 4)).astype(np.float32))
    lr = torch.tensor(0.05, dtype=torch.float32)

    def run(lr_t):
        t, a = torch.tensor(table), torch.full((64, 4), 0.1)
        sorted_adagrad_update_reference(t, a, ids, grads, lr_t, 1e-8)
        return t

    first = run(lr)
    lr.fill_(0.2)  # in place, as a schedule or a graph replay would see it
    second = run(lr)
    assert not torch.equal(first, second)
    assert torch.equal(second, run(torch.tensor(0.2, dtype=torch.float32)))


def test_adam_plain_version_reads_its_scalars_from_their_tensor():
    rng = np.random.default_rng(6)
    table = rng.normal(size=(64, 4)).astype(np.float32)
    ids = torch.tensor(np.sort(rng.integers(0, 64, size=40)).astype(np.int32))
    grads = torch.tensor(rng.normal(size=(40, 4)).astype(np.float32))
    step = torch.tensor(0, dtype=torch.int32)
    lr = torch.tensor(0.01, dtype=torch.float32)

    def run(scalars):
        t, m, v = torch.tensor(table), torch.zeros(64, 4), torch.zeros(64, 4)
        sorted_adam_update_reference(t, m, v, ids, grads, scalars, B1, B2, EPS)
        return t

    scalars = adam_scalars(lr, step, B1, B2)
    first = run(scalars)
    step.add_(5)  # the step tensor advances in place: new bias corrections
    later = adam_scalars(lr, step, B1, B2)
    scalars.copy_(later)
    second = run(scalars)
    assert not torch.equal(first, second)
    assert torch.equal(second, run(later))
    assert float(later[1]) == float(np.float32(1) - np.float32(B1) ** np.float32(6))


# ------------------------------------------------------------ the step
@pytest.mark.parametrize("slice3", [False, True], ids=["slice2", "slice3"])
def test_jit_train_step_equals_train_step_on_the_cpu(slice3):
    eng, schema = _tiny_engine(slice3)
    eager, compiled = eng.init(seed=0, device="cpu"), eng.init(seed=0, device="cpu")
    ts = eng.jit_train_step()
    for b in _batches(schema, 3):
        eager, me = eng.train_step(eager, *b)
        compiled, mc = ts(compiled, *b)
        assert torch.equal(me["loss"], mc["loss"]) and mc["overflow"] == 0
        assert _same_bits(compiled, _snapshot(eager))
    assert int(compiled.step) == 3 and ts.graphs == 0  # no capture on the CPU


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_jit_train_step_equals_train_step_on_afm(bf16):
    """AFM (the fused table through the engine's slicing route, the pair
    products' own backward, the f32 softmax): ``jit_train_step`` bit for bit
    ``train_step`` over three steps on the CPU."""
    cfg = TrainConfig(model="afm", vocab_size=50, embed_dim=16, attention_dim=8, bf16=bf16)
    schema = build_schema(cfg)
    eng = Engine(build_model("afm", schema, **cfg.model_kwargs()))
    eager, compiled = eng.init(seed=0, device="cpu"), eng.init(seed=0, device="cpu")
    ts = eng.jit_train_step()
    for b in _batches(schema, 3):
        eager, me = eng.train_step(eager, *b)
        compiled, mc = ts(compiled, *b)
        assert torch.equal(me["loss"], mc["loss"])
        assert _same_bits(compiled, _snapshot(eager))
    assert int(compiled.step) == 3 and ts.graphs == 0


def test_jit_train_step_hands_back_a_copy_of_the_loss():
    eng, schema = _tiny_engine(slice3=False)
    state = eng.init(seed=0, device="cpu")
    ts = eng.jit_train_step()
    bs = _batches(schema, 2)
    state, m0 = ts(state, *bs[0])
    kept = m0["loss"].clone()
    state, m1 = ts(state, *bs[1])
    assert torch.equal(m0["loss"], kept) and not torch.equal(m0["loss"], m1["loss"])


def test_jit_train_scan_losses_equal_train_scans():
    eng, schema = _tiny_engine(slice3=True)
    bs = _batches(schema, 3)
    stack = [torch.stack([b[i] for b in bs]) for i in range(3)]
    a, b = eng.init(seed=0, device="cpu"), eng.init(seed=0, device="cpu")
    a, ma = eng.train_scan(a, *stack)
    b, mb = eng.jit_train_scan()(b, *stack)
    assert mb["losses"].shape == (3,) and torch.equal(ma["losses"], mb["losses"])
    assert torch.equal(ma["loss"], mb["loss"]) and mb["overflow"] == 0
    assert _same_bits(b, _snapshot(a))


def test_a_second_state_or_batch_shape_does_not_write_into_the_first():
    eng, schema = _tiny_engine(slice3=False)
    first, second = eng.init(seed=0, device="cpu"), eng.init(seed=1, device="cpu")
    ts = eng.jit_train_step()
    bs = _batches(schema, 2)
    for b in bs:
        first, _ = ts(first, *b)
    kept = _snapshot(first)
    for b in bs:
        second, _ = ts(second, *b)
    assert _same_bits(first, kept) and int(second.step) == 2
    kept2 = _snapshot(second)
    small = _batches(schema, 1, batch=16, seed=2)[0]
    first, _ = ts(first, *small)  # another state and another shape
    assert _same_bits(second, kept2) and int(first.step) == 3
    assert not _same_bits(first, kept)


def test_shared_ids_tensor_is_sorted_once_a_step(monkeypatch):
    """Slice 3: ``emb`` and ``wide`` share one ids tensor, so one step runs
    ``slot_sorted_ids`` once, and the tables and moments are bit for bit
    those of the per-group sort."""
    eng, schema = _tiny_engine(slice3=True)
    calls = []
    sort = sparse_optim.slot_sorted_ids

    def counted(ids_2d):
        calls.append(ids_2d)
        return sort(ids_2d)

    monkeypatch.setattr(engine_module, "slot_sorted_ids", counted)
    monkeypatch.setattr(sparse_optim, "slot_sorted_ids", counted)
    shared, per_group = eng.init(seed=0, device="cpu"), eng.init(seed=0, device="cpu")
    bs = _batches(schema, 2)
    for b in bs:
        shared, _ = eng.train_step(shared, *b)
    assert len(calls) == len(bs)

    def apply_per_group(self, emb_params, emb_opt, gids, grad_rows, step, lr):
        for name, coll in self.collections.items():
            for g in coll.groups:
                gr = grad_rows[name][g.name]
                sparse_optim.apply_updates(self.sparse_opt, emb_params[name][g.name], emb_opt[name][g.name],
                                           gids[name][g.name], gr.reshape(-1) if g.dim == 1 else
                                           gr.reshape(-1, g.dim), step, lr)
        return emb_params, emb_opt

    monkeypatch.setattr(LocalTables, "apply_grads", apply_per_group)
    calls.clear()
    for b in bs:
        per_group, _ = eng.train_step(per_group, *b)
    assert len(calls) == 2 * len(bs)
    assert _same_bits(shared, _snapshot(per_group))


# ------------------------------------------------------------ serving
@pytest.mark.parametrize("n", [1, 255, 256, 257, 1000, 16384])
def test_bucket_equals_jaxs(n):
    want = JPredictor._bucket(types.SimpleNamespace(min_bucket=256), n)
    assert Predictor._bucket(types.SimpleNamespace(min_bucket=256), n) == want


@pytest.fixture(scope="module", params=[False, True], ids=["f32", "bf16"])
def artifact(request, tmp_path_factory):
    """A small xDeepFM trained two steps in JAX and exported by it."""
    cfg = JConfig(model="xdeepfm", vocab_size=500, embed_dim=8, cin_sizes=(16, 16), hidden=(32, 32),
                  bf16=request.param)
    schema = jbuild_schema(cfg)
    eng = JEngine(jbuild_model(cfg.model, schema, **cfg.model_kwargs()), dense_lr=1e-2, emb_lr=5e-2)
    state = eng.init(jax.random.key(0))
    step = eng.jit_train_step()
    it = iter(SyntheticSource(schema, batch_size=128, seed=1))
    for _ in range(2):
        b = next(it)
        state, _ = step(state, jnp.asarray(b.dense), jnp.asarray(b.ids), jnp.asarray(b.labels))
    art = str(tmp_path_factory.mktemp("artifact"))
    jexport(art, cfg, eng, jax.device_get(state))
    batch = next(iter(SyntheticSource(schema, batch_size=300, seed=9)))
    return dict(art=art, bf16=request.param, batch=batch)


def _close(got, want, bf16):
    if bf16:
        assert np.max(np.abs(got - want)) <= 0.03 * np.max(np.abs(want)) + 1e-3
    else:
        np.testing.assert_allclose(got, want, **F32_TOL)


def test_padded_predictor_matches_jax_and_the_unpadded_logits(artifact):
    """Padded to its bucket, a request's logits are bit for bit the eager
    logits of the padded batch's first rows, and within the serving
    tolerance of JAX's Predictor and of the eager logits of the unpadded
    request (a matrix product of one row may sum in another order than one
    of 256: 1 of 1 f32 logits one ulp apart at n = 1 here)."""
    pred = load_predictor(artifact["art"], device="cpu")
    jpred = jload(artifact["art"])
    b = artifact["batch"]
    for n in (1, 100, 300):  # buckets 256, 256, 512
        got = pred.predict_logits(b.dense[:n], b.ids[:n])
        assert got.shape == (n,) and got.dtype == np.float32
        _close(got, jpred.predict_logits(b.dense[:n], b.ids[:n]), artifact["bf16"])
        bucket = pred._bucket(n)
        dense = np.concatenate([b.dense[:n], np.zeros((bucket - n, b.dense.shape[1]), np.float32)])
        ids = np.concatenate([b.ids[:n], np.zeros((bucket - n, b.ids.shape[1]), np.int32)])
        with torch.inference_mode():
            padded = pred.engine.logits(pred.state, torch.from_numpy(dense), torch.from_numpy(ids))
            unpadded = pred.engine.logits(pred.state, torch.from_numpy(b.dense[:n]),
                                          torch.from_numpy(b.ids[:n]))
        np.testing.assert_array_equal(got, padded[:n].numpy())
        _close(got, unpadded.numpy(), artifact["bf16"])


def test_load_predictor_forwards_min_bucket(artifact):
    pred = load_predictor(artifact["art"], min_bucket=64, device="cpu")
    assert pred.min_bucket == 64 and pred._bucket(65) == 128
    assert load_predictor(artifact["art"], device="cpu").min_bucket == 256
