"""The whole serving slice on the CPU: a small xDeepFM trained a few steps in
JAX, exported by the JAX package, served by the port's ``load_predictor``,
and the other way round (an artifact the port exports loads in the JAX
package). Logits are held against JAX's jitted ``Engine.logits`` on the same
batches, ragged sizes included."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recmodels_tpu.data import SyntheticSource
from recmodels_tpu.models import build_model as jbuild_model
from recmodels_tpu.serve import _canonical_tables
from recmodels_tpu.serve import export_model as jexport
from recmodels_tpu.serve import load_predictor as jload
from recmodels_tpu.train.engine import Engine as JEngine
from recmodels_tpu.train.loop import build_schema as jbuild_schema
from recmodels_tpu.utils.config import TrainConfig as JConfig
from recmodels_tpu_torch.models import build_model
from recmodels_tpu_torch.serve import export_model, load_predictor, params_from_jax, treedef_str
from recmodels_tpu_torch.train.engine import Engine
from recmodels_tpu_torch.utils.config import TrainConfig, build_schema
from recmodels_tpu_torch.utils.tree import leaves

SIZES = (1, 7, 64, 100)
# f32: the same math in another summation order
F32_TOL = dict(rtol=1e-5, atol=1e-5)


def _bf16_close(got, want):
    """bf16: the port's fused CIN is the pair-pool form of the TPU kernel
    (rounding x1 and Q to bf16), JAX's CPU path the per-layer einsums, and
    bf16 MLP activations can round one step apart; the repo's bf16 rule
    (tests/test_tpu_kernels.py) bounds it: max |err| <= 0.03 max |ref| + 1e-3."""
    assert np.max(np.abs(got - want)) <= 0.03 * np.max(np.abs(want)) + 1e-3


def _train_jax(cfg: JConfig, steps: int = 3, fuse_wide: bool = True):
    schema = jbuild_schema(cfg)
    eng = JEngine(jbuild_model(cfg.model, schema, **cfg.model_kwargs()),
                  dense_lr=1e-2, emb_lr=5e-2, fuse_wide=fuse_wide)
    state = eng.init(jax.random.key(0))
    step = eng.jit_train_step()
    it = iter(SyntheticSource(schema, batch_size=128, seed=1))
    for _ in range(steps):  # the wide column and every weight move off their init
        b = next(it)
        state, _ = step(state, jnp.asarray(b.dense), jnp.asarray(b.ids), jnp.asarray(b.labels))
    return eng, jax.device_get(state), schema


def _cfg(bf16: bool) -> dict:
    return dict(model="xdeepfm", vocab_size=500, embed_dim=8, cin_sizes=(16, 16),
                hidden=(32, 32), bf16=bf16)


@pytest.fixture(scope="module", params=[False, True], ids=["f32", "bf16"])
def trained(request, tmp_path_factory):
    cfg = JConfig(**_cfg(request.param))
    eng, state, schema = _train_jax(cfg)
    art = str(tmp_path_factory.mktemp("artifact"))
    jexport(art, cfg, eng, state)
    batch = next(iter(SyntheticSource(schema, batch_size=max(SIZES), seed=9)))
    want = np.asarray(jax.jit(eng.logits)(state, jnp.asarray(batch.dense), jnp.asarray(batch.ids)))
    return dict(bf16=request.param, cfg=cfg, eng=eng, state=state, art=art, batch=batch, want=want)


def _check(got, want, bf16):
    if bf16:
        _bf16_close(got, want)
    else:
        np.testing.assert_allclose(got, want, **F32_TOL)


@pytest.mark.parametrize("n", SIZES)
def test_port_serves_jax_artifact(trained, n):
    pred = load_predictor(trained["art"], device="cpu")
    b = trained["batch"]
    got = pred.predict_logits(b.dense[:n], b.ids[:n])
    assert got.shape == (n,) and got.dtype == np.float32
    # JAX's jitted logits on the same n-example batch
    want = np.asarray(jax.jit(trained["eng"].logits)(
        trained["state"], jnp.asarray(b.dense[:n]), jnp.asarray(b.ids[:n])))
    _check(got, want, trained["bf16"])


def test_params_from_live_jax_state_match_artifact(trained):
    pred = load_predictor(trained["art"], device="cpu")
    state = trained["state"]
    leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(state.dense_params)]
    tables = _canonical_tables(trained["eng"], state.emb_params)
    live = params_from_jax(pred.engine, leaves, tables, device="cpu")
    b = trained["batch"]
    with torch.inference_mode():
        got = pred.engine.logits(live, torch.from_numpy(b.dense), torch.from_numpy(b.ids)).numpy()
    np.testing.assert_array_equal(got, pred.predict_logits(b.dense, b.ids))
    _check(got, trained["want"], trained["bf16"])


def test_port_artifact_loads_in_jax(trained, tmp_path):
    """An artifact written by the port's export_model loads in the JAX
    package and gives the JAX model's logits: the weights round-trip
    exactly, so the jitted graphs agree bit for bit."""
    pred = load_predictor(trained["art"], device="cpu")
    out = str(tmp_path / "from_port")
    export_model(out, TrainConfig(**_cfg(trained["bf16"])), pred.engine, pred.state)
    jpred = jload(out, min_bucket=max(SIZES))
    b = trained["batch"]
    np.testing.assert_array_equal(jpred.predict_logits(b.dense, b.ids), trained["want"])


def test_serving_state_without_optimizer_states_round_trips(trained, tmp_path):
    """A serving state leaves ``dense_opt`` and ``emb_opt`` None; it exports
    and loads in both packages, and a training state (with both optimizer
    states) exports the very same artifact, so the format is unchanged."""
    pred = load_predictor(trained["art"], device="cpu")
    assert pred.state.dense_opt is None and pred.state.emb_opt is None
    out = str(tmp_path / "serving")
    export_model(out, TrainConfig(**_cfg(trained["bf16"])), pred.engine, pred.state)
    back = load_predictor(out, device="cpu")
    assert back.state.dense_opt is None and back.state.emb_opt is None
    b = trained["batch"]
    np.testing.assert_array_equal(back.predict_logits(b.dense, b.ids), pred.predict_logits(b.dense, b.ids))
    np.testing.assert_array_equal(jload(out, min_bucket=max(SIZES)).predict_logits(b.dense, b.ids),
                                  trained["want"])
    training = pred.state._replace(
        dense_opt=pred.engine.dense_tx.init(list(leaves(pred.state.dense_params))),
        emb_opt=pred.engine.tables.init_opt(pred.state.emb_params))
    out2 = str(tmp_path / "training")
    export_model(out2, TrainConfig(**_cfg(trained["bf16"])), pred.engine, training)
    with np.load(os.path.join(out, "params.npz")) as x, np.load(os.path.join(out2, "params.npz")) as y:
        assert sorted(x.files) == sorted(y.files)
        for k in x.files:
            np.testing.assert_array_equal(x[k], y[k])


def test_treedef_string_is_jaxs(trained):
    pred = load_predictor(trained["art"], device="cpu")
    assert treedef_str(pred.state.dense_params) == str(
        jax.tree_util.tree_structure(trained["state"].dense_params))


def test_model_apply_matches_jax_unfused_engine():
    """``XDeepFMModel.apply`` (separate 'emb' [B, m, D] and 'wide' [B, m, 1]
    activations, H-major MLP input) against the JAX engine that keeps the
    wide column in its own table, on the CPU plain ops."""
    cfg = JConfig(**_cfg(False))
    eng, state, schema = _train_jax(cfg, fuse_wide=False)
    tables = _canonical_tables(eng, state.emb_params)
    emb_t, wide_t = tables["emb/emb/d8"], tables["emb/wide/d1"]
    tcfg = TrainConfig(**_cfg(False))
    port = Engine(build_model("xdeepfm", build_schema(tcfg), **tcfg.model_kwargs()))
    live = params_from_jax(
        port, [np.asarray(x) for x in jax.tree_util.tree_leaves(state.dense_params)],
        {"emb/emb/d9": np.concatenate([emb_t, wide_t[:, None]], axis=1)}, device="cpu",
    )
    b = next(iter(SyntheticSource(schema, batch_size=50, seed=4)))
    gids = port.collections["emb"].group_row_ids(torch.from_numpy(b.ids))["d9"]
    acts = {"emb": torch.tensor(emb_t)[gids], "wide": torch.tensor(wide_t)[gids][..., None]}
    got = port.model.apply(live.dense_params, torch.from_numpy(b.dense), acts).numpy()
    want = np.asarray(jax.jit(eng.logits)(state, jnp.asarray(b.dense), jnp.asarray(b.ids)))
    np.testing.assert_allclose(got, want, **F32_TOL)


@pytest.mark.parametrize("bad", [-1, 500], ids=["negative", "past_vocab"])
def test_predictor_refuses_ids_outside_the_vocab(trained, bad):
    """The gather checks no range, so the scorer refuses such ids first."""
    pred = load_predictor(trained["art"], device="cpu")
    b = trained["batch"]
    ids = b.ids[:4].copy()
    ids[2, 5] = bad
    with pytest.raises(ValueError, match="outside slot 5's vocab"):
        pred.predict_logits(b.dense[:4], ids)
    with pytest.raises(ValueError, match=r"ids must be \[B, 26\]"):
        pred.predict_logits(b.dense[:4], b.ids[:4, :25])


def test_structure_mismatch_rejected(trained, tmp_path):
    art = str(tmp_path / "doctored")
    pred = load_predictor(trained["art"], device="cpu")
    export_model(art, TrainConfig(**_cfg(trained["bf16"])), pred.engine, pred.state)
    p = os.path.join(art, "model.json")
    with open(p) as f:
        d = json.load(f)
    d["hidden"] = [32, 32, 32]  # one more MLP layer than the artifact holds
    with open(p, "w") as f:
        json.dump(d, f)
    with pytest.raises(ValueError, match="structure mismatch"):
        load_predictor(art, device="cpu")


def test_entry_points_default_to_cuda(trained, monkeypatch):
    """With no GPU, the defaults raise rather than fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_predictor(trained["art"])
    eng = Engine(build_model("xdeepfm", build_schema(TrainConfig(**_cfg(True)))))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        eng.init(seed=0)


def test_engine_init_follows_jax_layout():
    cfg = TrainConfig(**_cfg(True))
    eng = Engine(build_model("xdeepfm", build_schema(cfg), **cfg.model_kwargs()))
    st = eng.init(seed=3, device="cpu")
    table = st.emb_params["emb"]["d9"]
    assert table.shape == (13 * 1024, 9) and table.dtype == torch.float32
    assert torch.count_nonzero(table[:, -1]) == 0  # the fused wide column starts at zero
    assert 0.04 < table[:, :-1].std().item() < 0.06
    jst = JEngine(jbuild_model("xdeepfm", jbuild_schema(JConfig(**_cfg(True))),
                               **JConfig(**_cfg(True)).model_kwargs())).init(jax.random.key(0))
    ours = jax.tree_util.tree_map(lambda t: t.numpy(), st.dense_params)
    assert jax.tree_util.tree_structure(ours) == jax.tree_util.tree_structure(jst.dense_params)
    assert [x.shape for x in jax.tree_util.tree_leaves(ours)] == [
        x.shape for x in jax.tree_util.tree_leaves(jst.dense_params)]


def test_unported_models_name_the_roadmap():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_model("deepfm", build_schema(TrainConfig(vocab_size=500)))
