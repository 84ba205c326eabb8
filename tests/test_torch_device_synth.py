"""In-graph data generation (``recmodels_tpu_torch/data/device_synth.py``,
``Engine.train_scan_gen``, the Trainer's generated loop and eval) on the CPU,
against the JAX package.

The port draws JAX's own stream: its threefry functions give
``jax.random``'s bits, so ids equal JAX's and every test can hold the port's
generated run against JAX's on the same examples. Tolerances:

* dense: ``log1p`` of PyTorch and of XLA on the CPU round apart by an ulp
  in about 6% of values (4.8e-7 at values below 8), so dense is held within
  1e-6 absolute;
* labels: ``u < sigmoid(logit)``, the logit summed in another order by the
  two packages (a few f32 ulps), so a label may differ only where its
  uniform lies within 1e-6 of its probability;
* training: the bounds ``tests/test_torch_train.py`` derives for steps of
  the two packages on inputs that differ by rounding (losses 1e-6, moments
  and tables 1e-6 of their largest value, the dense params 1e-3 of an Adam
  step a step), and the goldens' AUC 2e-3 and logloss 4e-3 for whole
  Trainer runs.
"""

import functools
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recmodels_tpu.data import criteo_schema as jcriteo_schema
from recmodels_tpu.data.device_synth import _mix32 as jmix32
from recmodels_tpu.data.device_synth import make_device_batch_fn as jmake_batch_fn
from recmodels_tpu.models import build_model as jbuild_model
from recmodels_tpu.train.engine import Engine as JEngine
from recmodels_tpu.train.loop import Trainer as JTrainer
from recmodels_tpu.utils.config import TrainConfig as JConfig
from recmodels_tpu.utils.logging import MetricsLogger as JLogger
from recmodels_tpu_torch.data import device_synth as ds
from recmodels_tpu_torch.data.schema import criteo_schema
from recmodels_tpu_torch.models import build_model
from recmodels_tpu_torch.train.engine import Engine
from recmodels_tpu_torch.train.loop import Trainer
from recmodels_tpu_torch.utils.config import TrainConfig
from recmodels_tpu_torch.utils.logging import MetricsLogger
from recmodels_tpu_torch.utils.tree import leaves

DENSE_ATOL = 1e-6
LABEL_MARGIN = 1e-6
# tests/test_torch_train.py's accumulation bounds (its derivation there)
MOMENT_TOL = 1e-6
ADAM_STEP_TOL = 1e-3


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Each test on one intra-op thread: the test run shares the host's cores
    among its workers, and torch's thread pool in each of them (one thread a
    core) oversubscribes the cores many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _step(n: int) -> torch.Tensor:
    return torch.tensor(n, dtype=torch.int32)


def _quiet():
    return dict(logger=MetricsLogger(stream=io.StringIO()), device="cpu")


def _tensors(state):
    return [t for t in leaves(state._asdict()) if isinstance(t, torch.Tensor)]


def _equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(_tensors(a), _tensors(b)))


# ------------------------------------------------------------ threefry
def test_jax_draws_by_partitionable_threefry():
    """The scheme the port reproduces: a JAX upgrade that changes it fails
    here, with this reason, before the bit-for-bit tests below."""
    assert jax.config.jax_threefry_partitionable, "the port reproduces jax_threefry_partitionable=True"
    assert jax.config.jax_default_prng_impl == "threefry2x32"


@pytest.mark.parametrize("step", [0, 5, 2**31 - 1])
@pytest.mark.parametrize("seed", [0, 3])
def test_fold_in_split_and_uniform_equal_jax(seed, step):
    jk = jax.random.fold_in(jax.random.key(seed), step)
    pk = ds.fold_in(ds.key(seed), _step(step))
    np.testing.assert_array_equal(pk.numpy(), np.asarray(jax.random.key_data(jk)).astype(np.int64))
    js, ps = jax.random.split(jk, 4), ds.split(pk, 4)
    np.testing.assert_array_equal(ps.numpy(), np.asarray(jax.random.key_data(js)).astype(np.int64))
    for i in range(4):  # an odd element count, and a 1-D draw
        for shape in ((7, 13), (5,)):
            want = np.asarray(jax.random.uniform(js[i], shape))
            got = ds.uniform(ps[i], shape).numpy()
            np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


# ---------------------------------------------------------- the batches
@pytest.mark.parametrize("step", [0, 1, 7, 123_456])
def test_batch_fn_draws_jax_batches(step):
    """``batch_fn`` against JAX's at the flagship's schema (26 x 1e5 ids),
    B = 4,096, on the same seed and task seed: ids equal, dense within
    DENSE_ATOL, labels equal but where |u - p| < LABEL_MARGIN."""
    b, seed = 4096, 11
    jfn = jax.jit(jmake_batch_fn(jcriteo_schema(vocab_size=100_000, embed_dim=16), b, seed=seed))
    pfn = ds.make_device_batch_fn(criteo_schema(vocab_size=100_000, embed_dim=16), b, seed=seed)
    jd, ji, jl = (np.asarray(x) for x in jfn(jnp.asarray(step, jnp.int32)))
    pd, pi, pl, bits = pfn(_step(step), with_bits=True)
    np.testing.assert_array_equal(pi.numpy(), ji)
    assert np.abs(pd.numpy() - jd).max() <= DENSE_ATOL
    # the port's label uniforms and probabilities
    u = ds.bits_to_unit(bits[:, -1]).numpy()
    z = ds.planted_logit(pd, ds.bucket_weight(pi), pfn.dense_w, pfn.slot_proj)
    p = torch.sigmoid(z - z.mean()).numpy()
    differ = pl.numpy() != jl
    assert np.all(np.abs(u - p)[differ] < LABEL_MARGIN), np.flatnonzero(differ)
    assert 0.3 < pl.mean().item() < 0.7


def test_bucket_weights_equal_jax_mix32():
    """``bucket_weight`` (``_mix32`` in int64 words) against the JAX
    package's uint32 ``_mix32`` on ids across the whole int32-vocab range,
    bit for bit."""
    rng = np.random.default_rng(5)
    ids = rng.integers(0, 2**31 - 1, size=(257, 26)).astype(np.int32)
    ids[0] = 0
    slot_c = (jnp.arange(26, dtype=jnp.uint32) * jnp.uint32(97531))[None, :]
    h = jmix32(jnp.asarray(ids).astype(jnp.uint32) * jnp.uint32(2654435761) + slot_c)
    want = ((h >> jnp.uint32(8)).astype(jnp.float32) * jnp.float32(1.0 / (1 << 24)) - 0.5) * 2.0
    got = ds.bucket_weight(torch.from_numpy(ids)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), np.asarray(want).view(np.int32))


def test_device_batch_shapes_and_determinism():
    """Mirror of tests/test_device_synth.py's first test on the port."""
    sch = criteo_schema(vocab_size=1000, embed_dim=8)
    fn = ds.make_device_batch_fn(sch, 256, seed=3)
    d1, i1, l1 = fn(_step(5))
    d2, i2, l2 = fn(_step(5))
    d3, i3, l3 = fn(_step(6))
    assert d1.shape == (256, sch.n_dense) and i1.shape == (256, sch.n_slots)
    assert l1.shape == (256,) and i1.dtype == torch.int32 and d1.dtype == l1.dtype == torch.float32
    assert torch.equal(d1, d2) and torch.equal(i1, i2) and torch.equal(l1, l2)
    assert not torch.equal(i1, i3)
    assert (i1 >= 0).all() and (i1 < torch.tensor(sch.vocab_sizes)[None, :]).all()
    assert (d1 >= 0).all() and 2.0 < d1.mean().item() < 5.0
    assert 0.3 < l1.mean().item() < 0.7


def test_device_synth_source_is_a_cursor():
    src = ds.DeviceSynthSource(criteo_schema(vocab_size=100), 64, seed=2)
    assert src.state() == {"step": 0}
    src.set_state({"step": 17})
    assert src.state() == {"step": 17}


def test_synth_batch_refuses_a_seed_outside_int32():
    with pytest.raises(ValueError, match="int32 range"):
        ds.make_device_batch_fn(criteo_schema(vocab_size=100), 64, seed=2**31)


# --------------------------------------------------------------- engine
def _small_xdeepfm():
    """tests/test_torch_train.py's small f32 xDeepFM in both packages,
    started from one JAX state (26 slots of a 50-id vocab, dim 16,
    CIN(32, 32), DNN(64, 64); dense Adam 1e-3, sparse Adagrad 1e-2)."""
    from torch_jax_bridge import port_state_from_jax

    kw = dict(model="xdeepfm", vocab_size=50, embed_dim=16, cin_sizes=(32, 32), hidden=(64, 64))
    jcfg, tcfg = JConfig(**kw), TrainConfig(**kw)
    from recmodels_tpu.train.loop import build_schema as jbuild_schema
    from recmodels_tpu_torch.utils.config import build_schema

    jeng = JEngine(jbuild_model("xdeepfm", jbuild_schema(jcfg), **jcfg.model_kwargs()), dense_lr=1e-3, emb_lr=1e-2)
    eng = Engine(build_model("xdeepfm", build_schema(tcfg), **tcfg.model_kwargs()), dense_lr=1e-3, emb_lr=1e-2)
    jstate = jeng.init(jax.random.key(0))
    return jeng, jstate, eng, lambda: port_state_from_jax(jeng, jstate, eng), build_schema(tcfg)


def test_train_scan_gen_matches_jax():
    """Eager ``train_scan_gen``, k = 3 from step 5, against JAX's
    ``train_scan_gen`` with the same ``batch_fn`` seed, from one JAX state:
    the three batches' ids and labels equal, the losses within 1e-6, and
    the state within tests/test_torch_train.py's bounds for two packages'
    steps on inputs that differ by rounding (its accumulation test): the
    moments, table and accumulator to MOMENT_TOL of their largest value,
    the dense params, which Adam moves by a grad's sign where it nearly
    cancels, to ADAM_STEP_TOL of a step a step (5e-7 seen on a CIN weight,
    where the dense inputs' log1p ulps reach the grads)."""
    from torch_jax_bridge import port_arrays, port_names, port_state_from_jax

    jeng, jstate, eng, port_state, schema = _small_xdeepfm()
    b, seed, step0, k = 64, 9, 5, 3
    jfn = jmake_batch_fn(jcriteo_schema(vocab_size=50, embed_dim=16), b, seed=seed)
    pfn = ds.make_device_batch_fn(schema, b, seed=seed)
    for i in range(k):
        _, ji, jl = jfn(jnp.asarray(step0 + i, jnp.int32))
        _, pi, pl = pfn(_step(step0 + i))
        np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(pl.numpy(), np.asarray(jl))  # none near its threshold here
    scan = jax.jit(functools.partial(jeng.train_scan_gen, k=k, batch_fn=jfn))
    jstate, jm = scan(jstate, jnp.asarray(step0, jnp.int32))
    state, m = eng.train_scan_gen(port_state(), step0, k=k, batch_fn=pfn)
    assert m["losses"].shape == (k,) and m["overflow"] == 0 and torch.equal(m["loss"], m["losses"][-1])
    np.testing.assert_allclose(m["losses"].numpy(), np.asarray(jm["losses"]), rtol=0, atol=1e-6)
    assert int(state.step) == int(jstate.step) == k
    want = port_arrays(port_state_from_jax(jeng, jstate, eng))
    for name, got, w in zip(port_names(state), port_arrays(state), want):
        got, w = got.astype(np.float64), w.astype(np.float64)
        atol = (ADAM_STEP_TOL * eng.dense_lr * k if name.startswith("dense_params/")
                else MOMENT_TOL * np.abs(w).max())
        assert np.abs(got - w).max() <= atol, (name, np.abs(got - w).max(), atol)


def test_captured_generated_scan_on_a_cpu_state_equals_eager():
    """``jit_train_scan_gen`` on a CPU state (the capture's code without a
    graph; the batch index is the state's step) against eager
    ``train_scan_gen`` from the same step: bit for bit, over a superbatch
    of 3 and a ragged one of 2."""
    _, _, eng, port_state, schema = _small_xdeepfm()
    fn = ds.make_device_batch_fn(schema, 64, seed=4)
    eager, captured = port_state(), port_state()
    scan = eng.jit_train_scan_gen(fn)
    for k in (3, 2):
        eager, me = eng.train_scan_gen(eager, int(eager.step), k=k, batch_fn=fn)
        captured, mc = scan(captured, k)
        assert torch.equal(me["losses"], mc["losses"]) and torch.equal(me["loss"], mc["loss"])
    assert int(captured.step) == 5 and _equal(eager, captured)


def test_generated_eval_on_a_cpu_state_equals_eager_eval():
    """``jit_eval_gen`` (generate batch ``index``, score it, advance
    ``index``) against ``eval_step`` on ``batch_fn(0..2)``: the same AUC
    state bit for bit, and the index at 3."""
    from recmodels_tpu_torch.train.metrics import auc_init

    _, _, eng, port_state, schema = _small_xdeepfm()
    state, fn = port_state(), ds.make_device_batch_fn(schema, 64, seed=8)
    want, got = auc_init(device="cpu"), auc_init(device="cpu")
    index = torch.zeros((), dtype=torch.int32)
    eval_gen = eng.jit_eval_gen(fn)
    for i in range(3):
        eng.eval_step(state, want, *fn(_step(i)))
        eval_gen(state, got, index)
    assert int(index) == 3
    assert all(torch.equal(a, b) for a, b in zip(got, want))


# -------------------------------------------------------------- Trainer
def test_trainer_device_synth_learns():
    """Mirror of tests/test_device_synth.py's Trainer test at JAX's
    settings: DeepFM reaches val AUC > 0.70 on the generated held-out
    stream after 300 generated steps."""
    cfg = TrainConfig(model="deepfm", hidden=(128, 128), vocab_size=5000, embed_dim=16, batch_size=512,
                      steps=300, scan_steps=10, log_every=100, eval_every=300, eval_batches=20,
                      dense_lr=1e-3, emb_lr=5e-2, n_devices=1, data="device_synth")
    t = Trainer(cfg, **_quiet())
    final = t.run()
    assert final["auc"] > 0.70, final
    assert int(t.state.step) == 300


def test_trainer_device_synth_resume(tmp_path):
    """Mirror of tests/test_device_synth.py's resume test: 40 steps straight
    against 20 and a new Trainer resuming to 40, bit for bit."""
    base = dict(model="fm", vocab_size=500, embed_dim=8, batch_size=128, steps=40, scan_steps=5,
                eval_every=0, log_every=20, emb_lr=5e-2, n_devices=1, data="device_synth", ckpt_every=10)
    t1 = Trainer(TrainConfig(**{**base, "ckpt_dir": str(tmp_path / "a")}), **_quiet())
    t1.run()
    Trainer(TrainConfig(**{**base, "steps": 20, "ckpt_dir": str(tmp_path / "b")}), **_quiet()).run()
    log = io.StringIO()
    t3 = Trainer(TrainConfig(**{**base, "ckpt_dir": str(tmp_path / "b")}), logger=MetricsLogger(stream=log),
                 device="cpu")
    t3.run()
    assert "resumed from checkpoint at step 20" in log.getvalue()
    assert int(t3.state.step) == 40 and _equal(t1.state, t3.state)


def test_trainer_device_synth_from_jax_initial_state_lands_on_jax_trainer():
    """FM on the generated stream (and its generated held-out stream) from
    the JAX Trainer's initial state, against JAX's Trainer on the same
    configuration: val AUC within 2e-3 and logloss within 4e-3 (the
    goldens' bounds), with a ragged last superbatch and two evals."""
    from torch_jax_bridge import port_state_from_jax

    kw = dict(model="fm", vocab_size=500, embed_dim=8, batch_size=256, steps=150, scan_steps=20, log_every=50,
              eval_every=75, eval_batches=5, emb_lr=5e-2, n_devices=1, data="device_synth")
    jt = JTrainer(JConfig(**kw), logger=JLogger(stream=io.StringIO()))
    jstate0 = jt.engine.init(jax.random.key(0))
    jfinal = jt.run()
    t = Trainer(TrainConfig(**kw), **_quiet())
    t.engine.init = lambda seed, device: port_state_from_jax(jt.engine, jstate0, t.engine)
    final = t.run()
    assert int(t.state.step) == 150
    assert abs(final["auc"] - jfinal["auc"]) < 2e-3, (final, jfinal)
    assert abs(final["logloss"] - jfinal["logloss"]) < 4e-3, (final, jfinal)


def test_trainer_device_synth_refuses_accumulation_as_jax_does():
    cfg = TrainConfig(model="fm", vocab_size=500, embed_dim=8, batch_size=128, steps=4, accum_steps=2,
                      data="device_synth")
    with pytest.raises(NotImplementedError, match="device_synth does not compose with accum_steps"):
        Trainer(cfg, **_quiet()).run()
    with pytest.raises(NotImplementedError, match="device_synth does not compose with accum_steps"):
        JTrainer(JConfig.from_json(cfg.apply_overrides(["n_devices=1"]).to_json()),
                 logger=JLogger(stream=io.StringIO())).run()


def test_train_cli_reaches_the_generated_loop(tmp_path, capsys):
    """``cli.train --cpu --data device_synth``: the generated loop trains,
    logs, evaluates on the generated held-out stream and checkpoints its
    cursor, the step."""
    import json
    import os

    from recmodels_tpu_torch.cli import train as train_cli

    ckpt = str(tmp_path / "ckpt")
    rc = train_cli.main(["--cpu", "--model", "fm", "--data", "device_synth", "--steps", "12", "--batch-size", "64",
                         "--ckpt-dir", ckpt, "--set", "vocab_size=200", "--set", "embed_dim=8",
                         "--set", "scan_steps=5", "--set", "log_every=5", "--set", "eval_every=12",
                         "--set", "eval_batches=2", "--set", "ckpt_every=10"])
    out = capsys.readouterr().out
    assert rc == 0 and "data=device_synth" in out and " val " in out
    # the first save at any step (orbax's policy), then every 10, and the last
    assert sorted(int(d) for d in os.listdir(ckpt) if d.isdigit()) == [5, 10, 12]
    assert json.loads((tmp_path / "ckpt" / "12" / "data.json").read_text()) == {"step": 12}
