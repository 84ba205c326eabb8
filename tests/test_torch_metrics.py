"""The port's streaming AUC/logloss (``train/metrics.py``) and its eval step
(``Engine.eval_step``, ``jit_eval_step``) on the CPU against the JAX
package's (``recmodels_tpu/train/metrics.py``, ``Engine.eval_step``).

* The same logits (numpy, from a seed) through both ``auc_update``s give
  the same int32 histograms and count, with and without a 0/1 weight, and
  the f32 loss sums agree to rtol 1e-5 (sums in another order). The bins
  agree bit for bit unless the two f32 sigmoids land an ulp apart across a
  bin edge (``train/metrics.py``), and each
  such example moves two counts at most; on these logits none does, so the
  histograms are equal.
* ``auc_compute`` on equal states agrees with JAX's to 1e-12 (both in
  float64 on the host).
* States merge exactly: integer counts add, and a split stream's merged
  histograms are the whole stream's.
* Counts stay exact past 2^24 a bin.
* ``Engine.eval_step`` on weights carried over by ``params_from_jax``
  against JAX's ``eval_step``: the logits agree to f32 rounding order
  (rtol 1e-5), so an example can land in another bin only where its two
  logits straddle a bin edge; the histograms may differ by at most two
  counts for each such example, and the count and loss sum agree.
* ``jit_eval_step`` on a CPU state runs ``eval_step`` on static buffers:
  bit for bit the same state, with a masked tail batch too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import rankdata

from recmodels_tpu.data import SyntheticSource
from recmodels_tpu.models import build_model as jbuild_model
from recmodels_tpu.serve import _canonical_tables
from recmodels_tpu.train import metrics as JM
from recmodels_tpu.train.engine import Engine as JEngine
from recmodels_tpu.train.loop import build_schema as jbuild_schema
from recmodels_tpu.utils.config import TrainConfig as JConfig
from recmodels_tpu_torch.models import build_model
from recmodels_tpu_torch.serve import params_from_jax
from recmodels_tpu_torch.train import AUCState, auc_compute, auc_init, auc_update
from recmodels_tpu_torch.train import metrics as TM
from recmodels_tpu_torch.train.engine import Engine
from recmodels_tpu_torch.utils.config import TrainConfig, build_schema

K = TM.DEFAULT_BINS


def _stream(n: int, seed: int, scale: float = 2.0):
    rng = np.random.default_rng(seed)
    labels = (rng.random(n) < 0.3).astype(np.float32)
    logits = (labels * 1.2 - 0.6 + rng.normal(0, scale, n)).astype(np.float32)
    weight = (rng.random(n) < 0.8).astype(np.float32)
    return logits, labels, weight


def _jax_state(st: AUCState):
    return JM.AUCState(*(jnp.asarray(t.numpy()) for t in st))


def _bins_moved(logits: np.ndarray) -> int:
    """How many examples JAX's f32 sigmoid and the port's put in other bins."""
    jp = np.asarray(jax.nn.sigmoid(jnp.asarray(logits)))
    tp = (1.0 / (1.0 + torch.exp(-torch.from_numpy(logits).double()).float())).numpy()
    return int(np.sum((jp * K).astype(np.int32) != (tp * K).astype(np.int32)))


def test_defaults_and_state_are_jaxs():
    assert TM.DEFAULT_BINS == JM.DEFAULT_BINS == 16384
    st = auc_init(device="cpu")
    jst = JM.auc_init()
    assert AUCState._fields == JM.AUCState._fields
    for t, j in zip(st, jst):
        assert t.dtype == {jnp.int32: torch.int32, jnp.float32: torch.float32}[j.dtype.type]
        assert tuple(t.shape) == j.shape and not t.any()


@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "masked"])
@pytest.mark.parametrize("scale", [1.0, 4.0])
def test_auc_update_gives_jaxs_histograms(weighted, scale):
    """Three batches of one stream (20,000 logits), with and without a 0/1
    weight, through both packages' ``auc_update``."""
    logits, labels, weight = _stream(20_000, seed=int(scale), scale=scale)
    moved = _bins_moved(logits)  # 0 on these logits: the histograms are equal
    st, jst = auc_init(device="cpu"), JM.auc_init()
    for chunk in np.array_split(np.arange(logits.size), 3):
        w = weight[chunk] if weighted else None
        out = auc_update(st, torch.from_numpy(logits[chunk]), torch.from_numpy(labels[chunk]),
                         None if w is None else torch.from_numpy(w))
        assert out is st  # in place
        jst = JM.auc_update(jst, jnp.asarray(logits[chunk]), jnp.asarray(labels[chunk]),
                            None if w is None else jnp.asarray(w))
    for name in ("pos_hist", "neg_hist"):
        got, want = getattr(st, name), np.asarray(getattr(jst, name))
        assert got.dtype == torch.int32
        assert np.abs(got.numpy().astype(np.int64) - want).sum() <= 2 * moved, (name, moved)
    assert st.count.dtype == torch.int32 and int(st.count) == int(jst.count)
    assert int(st.count) == (int(weight.sum()) if weighted else logits.size)
    np.testing.assert_allclose(float(st.loss_sum), float(jst.loss_sum), rtol=1e-5)


@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "masked"])
def test_auc_compute_matches_jax_on_equal_states(weighted):
    logits, labels, weight = _stream(8192, seed=5)
    st = auc_update(auc_init(device="cpu"), torch.from_numpy(logits), torch.from_numpy(labels),
                    torch.from_numpy(weight) if weighted else None)
    got, want = auc_compute(st), JM.auc_compute(_jax_state(st))
    assert sorted(got) == sorted(want)
    for k in want:
        assert abs(float(got[k]) - float(want[k])) <= 1e-12, k


def test_streaming_auc_and_logloss_match_exact():
    """Histogram AUC within 1e-4 of the exact rank AUC (scipy's midranks),
    logloss the mean BCE to rtol 1e-5."""
    logits, labels, _ = _stream(20_000, seed=6, scale=1.0)
    st = auc_init(device="cpu")
    for chunk in np.array_split(np.arange(logits.size), 7):
        auc_update(st, torch.from_numpy(logits[chunk]), torch.from_numpy(labels[chunk]))
    out = auc_compute(st)
    pos = labels == 1
    n_pos, n_neg = int(pos.sum()), int((~pos).sum())
    exact = (rankdata(logits)[pos].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg)
    assert abs(float(out["auc"]) - exact) < 1e-4
    p = 1.0 / (1.0 + np.exp(-logits.astype(np.float64)))
    ll = -np.mean(labels * np.log(p) + (1 - labels) * np.log(1 - p))
    np.testing.assert_allclose(float(out["logloss"]), ll, rtol=1e-5)
    assert out["count"] == logits.size and int(st.count) == logits.size


def test_auc_merge_is_exactly_additive():
    logits, labels, weight = _stream(6000, seed=7)
    t = [torch.from_numpy(a) for a in (logits, labels, weight)]
    full = auc_update(auc_init(device="cpu"), *t)
    a = auc_update(auc_init(device="cpu"), *(x[:2500] for x in t))
    b = auc_update(auc_init(device="cpu"), *(x[2500:] for x in t))
    merged = TM.auc_merge(a, b)
    for name in AUCState._fields:
        assert torch.equal(getattr(merged, name), getattr(a, name) + getattr(b, name))
    for name in ("pos_hist", "neg_hist", "count"):
        assert torch.equal(getattr(merged, name), getattr(full, name))
    np.testing.assert_allclose(float(merged.loss_sum), float(full.loss_sum), rtol=1e-6)
    assert auc_compute(merged)["auc"] == auc_compute(full)["auc"]


def test_counts_exact_past_2pow24():
    """int32 histograms take one more example at 20M counts a bin, where f32
    would absorb it (the case of tests/test_metrics.py)."""
    big = 20_000_000
    st = auc_init(device="cpu")
    st.pos_hist[100] = big
    st.neg_hist[50] = big
    st.count.fill_(2 * big)
    auc_update(st, torch.tensor([4.0]), torch.tensor([1.0]))
    assert int(st.count) == 2 * big + 1 and int(st.pos_hist.sum()) == big + 1
    assert auc_compute(st)["auc"] == 1.0
    assert np.float32(big) + np.float32(1.0) == np.float32(big)


# ------------------------------------------------------------------ eval
def _engines(model: str = "deepfm"):
    cfg = dict(model=model, vocab_size=50, embed_dim=16, hidden=(64, 64), attention_dim=8)
    jcfg, tcfg = JConfig(**cfg), TrainConfig(**cfg)
    schema = jbuild_schema(jcfg)
    jeng = JEngine(jbuild_model(model, schema, **jcfg.model_kwargs()))
    eng = Engine(build_model(model, build_schema(tcfg), **tcfg.model_kwargs()))
    return jeng, eng, schema


@pytest.mark.parametrize("model", ["deepfm", "afm"])
def test_eval_step_matches_jax(model):
    """Four batches of 512 through JAX's jitted ``eval_step`` and the port's,
    from one JAX state trained three steps (so every weight is live)."""
    jeng, eng, schema = _engines(model)
    jstate = jeng.init(jax.random.key(0))
    step = jax.jit(jeng.train_step)
    it = iter(SyntheticSource(schema, batch_size=512, seed=1))
    for _ in range(3):
        b = next(it)
        jstate, _ = step(jstate, jnp.asarray(b.dense), jnp.asarray(b.ids), jnp.asarray(b.labels))
    jstate = jax.device_get(jstate)
    state = params_from_jax(eng, [np.asarray(x) for x in jax.tree_util.tree_leaves(jstate.dense_params)],
                            _canonical_tables(jeng, jstate.emb_params), device="cpu")
    jeval = jax.jit(jeng.eval_step)
    jauc, auc = JM.auc_init(), auc_init(device="cpu")
    near_edge = 0
    edges = np.log(np.arange(1, K) / (K - np.arange(1, K)))  # logit of each bin edge
    for b in zip(range(4), SyntheticSource(schema, batch_size=512, seed=99)):
        b = b[1]
        jauc = jeval(jstate, jauc, jnp.asarray(b.dense), jnp.asarray(b.ids), jnp.asarray(b.labels))
        assert eng.eval_step(state, auc, torch.from_numpy(b.dense), torch.from_numpy(b.ids),
                             torch.from_numpy(b.labels)) is auc
        zj = np.asarray(jax.jit(jeng.logits)(jstate, jnp.asarray(b.dense), jnp.asarray(b.ids)))
        with torch.inference_mode():
            zp = eng.logits(state, torch.from_numpy(b.dense), torch.from_numpy(b.ids)).numpy()
        np.testing.assert_allclose(zp, zj, rtol=1e-5, atol=1e-5)
        lo = np.minimum(zp, zj).astype(np.float64) - 1e-6 * (1 + np.abs(zj))
        hi = np.maximum(zp, zj).astype(np.float64) + 1e-6 * (1 + np.abs(zj))
        near_edge += int(np.sum(np.searchsorted(edges, hi) > np.searchsorted(edges, lo)))
    assert int(auc.count) == int(jauc.count) == 4 * 512
    for name in ("pos_hist", "neg_hist"):
        diff = np.abs(getattr(auc, name).numpy().astype(np.int64) - np.asarray(getattr(jauc, name)))
        assert diff.sum() <= 2 * near_edge, (name, diff.sum(), near_edge)
    np.testing.assert_allclose(float(auc.loss_sum), float(jauc.loss_sum), rtol=1e-5)
    assert abs(auc_compute(auc)["auc"] - JM.auc_compute(jauc)["auc"]) <= near_edge / (4 * 512) + 1e-12


@pytest.mark.parametrize("model", ["deepfm", "lr"])
def test_jit_eval_step_equals_eval_step_on_the_cpu(model):
    """``jit_eval_step`` on a CPU state: three batches of 64 and a masked
    tail batch (a weight of 0/1), bit for bit ``eval_step``'s state; the
    callable returns the state it was given."""
    _, eng, schema = _engines(model)
    state = eng.init(seed=0, device="cpu")
    es = eng.jit_eval_step()
    eager, compiled = auc_init(device="cpu"), auc_init(device="cpu")
    it = iter(SyntheticSource(schema, batch_size=64, seed=3))
    batches = [[torch.from_numpy(a) for a in (b.dense, b.ids, b.labels)] for b in (next(it) for _ in range(4))]
    weight = torch.zeros(64)
    weight[:40] = 1.0
    for k, b in enumerate(batches):
        w = weight if k == 3 else None
        assert eng.eval_step(state, eager, *b, w) is eager
        assert es(state, compiled, *b, w) is compiled
        for x, y in zip(eager, compiled):
            assert torch.equal(x, y)
    assert int(compiled.count) == 3 * 64 + 40 and es.graphs == 0
