"""The training slices as a whole on the CPU: a small xDeepFM (26 slots of a
50-id vocab, so ids repeat; dim 16; DNN(64, 64); batch 64) trained two
steps in JAX, carried into the port by ``serve.train_state_from_jax``, then
three ``train_step``s in both packages on identical batches.

* slice 2 (``run``): CIN(32, 32), the fused wide column, dense Adam at lr
  1e-3 and sparse Adagrad at lr 1e-2, as the JAX engine's defaults;
* slice 3 (``run3``): CIN(128, 128, 128) (512-row multiples, so layers 2
  and 3 take the layer backward kernel's plain version, as JAX's condition
  says), ``fuse_wide=False`` (a dim-16 ``emb`` table and a dim-1 ``wide``
  table) and lazy Adam at lr 1e-2 on both tables (``bench.py
  --sparse-opt adam``).

Tolerances:
* f32: both packages run the same math in another summation order, so the
  states agree to f32 rounding (rtol 1e-5).
* bf16: the port's CIN is the TPU kernel's pair-pool form and JAX's CPU path
  the per-layer einsums, so values round to bf16 at other places.
  - loss: BCE is 1-Lipschitz in each logit, so a step's losses differ by at
    most the mean logit difference, which the repo's bf16 rule bounds:
    0.03 * max |logit| + 1e-3 (logits of this model stay below 2).
  - Adam's moments after the three steps: the repo's bf16 rule, 3% of the
    largest |value| (the bf16-rounded grads feed them).
  - one step from the shared start (both dtypes): the change of the touched
    table and acc rows, and the dense grads read off Adam's first moment,
    within 3% of JAX's largest change of each part (a rounding one bf16 step apart moves
    a grad by about 2^-8 of its size). After the first step the bf16 states
    differ by such roundings, and Adam turns those into steps of its own
    (its step m/sqrt(v) is near sign(g) where the grads are new), so the
    params, table and acc are compared one step at a time.
  - untouched rows keep their bits after one step and after three.
  - lazy Adam's tables (slice 3) in bf16: Adam's step m/(sqrt(v) + eps)
    normalises the grad, so a grad within bf16 rounding of 0 moves a table
    element by most of a step either way (two elements at 0.4-0.5% of the
    largest grad, 7% of the largest change, in this run). The moments carry
    the grads and are held to 3% of JAX's largest change; the table's
    change is held to be the Adam step of the port's own moments, bit for
    bit. In f32 the tables are compared directly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recmodels_tpu.data import SyntheticSource
from recmodels_tpu.models import build_model as jbuild_model
from recmodels_tpu.serve import _canonical_tables
from recmodels_tpu.train.engine import Engine as JEngine
from recmodels_tpu.train.loop import build_schema as jbuild_schema
from recmodels_tpu.utils.config import TrainConfig as JConfig
from recmodels_tpu_torch.models import build_model
from recmodels_tpu_torch.embedding.update import adam_constants, adam_scalars
from recmodels_tpu_torch.serve import train_state_from_jax
from recmodels_tpu_torch.train.engine import Engine
from recmodels_tpu_torch.utils.config import TrainConfig, build_schema
from recmodels_tpu_torch.utils.tree import leaves

DENSE_LR, EMB_LR = 1e-3, 1e-2
WARM, STEPS = 2, 3
F32_TOL = dict(rtol=1e-5, atol=1e-6)
STEP_REL_TOL = 0.03


def _cfg(bf16: bool) -> dict:
    return dict(model="xdeepfm", vocab_size=50, embed_dim=16, cin_sizes=(32, 32),
                hidden=(64, 64), bf16=bf16)


def _np_state(state):
    """(dense leaves, Adam count, mu, nu, table, acc) of a JAX state."""
    adam = state.dense_opt[0]
    return ([np.asarray(x) for x in jax.tree_util.tree_leaves(state.dense_params)],
            int(adam.count),
            [np.asarray(x) for x in jax.tree_util.tree_leaves(adam.mu)],
            [np.asarray(x) for x in jax.tree_util.tree_leaves(adam.nu)],
            np.asarray(state.emb_params["emb"]["d17"]),
            np.asarray(state.emb_opt["emb"]["d17"]["acc"]))


def _port_np(state):
    return ([t.numpy() for t in leaves(state.dense_params)], int(state.dense_opt["count"]),
            [t.numpy() for t in state.dense_opt["mu"]], [t.numpy() for t in state.dense_opt["nu"]],
            state.emb_params["emb"]["d17"].numpy(), state.emb_opt["emb"]["d17"]["acc"].numpy())


@pytest.fixture(scope="module", params=[False, True], ids=["f32", "bf16"])
def run(request):
    """Both packages from one mid-training state through the same batches."""
    bf16 = request.param
    jcfg = JConfig(**_cfg(bf16))
    schema = jbuild_schema(jcfg)
    jeng = JEngine(jbuild_model("xdeepfm", schema, **jcfg.model_kwargs()),
                   dense_lr=DENSE_LR, emb_lr=EMB_LR)
    step = jax.jit(jeng.train_step)
    state = jeng.init(jax.random.key(0))
    batches = iter(SyntheticSource(schema, batch_size=64, seed=1))
    for _ in range(WARM):  # the wide column, the moments and acc move off their init
        b = next(batches)
        state, _ = step(state, jnp.asarray(b.dense), jnp.asarray(b.ids), jnp.asarray(b.labels))
    state = jax.device_get(state)
    dense, count, mu, nu, _, acc = _np_state(state)
    tcfg = TrainConfig(**_cfg(bf16))
    eng = Engine(build_model("xdeepfm", build_schema(tcfg), **tcfg.model_kwargs()),
                 dense_lr=DENSE_LR, emb_lr=EMB_LR)
    start = dict(step=int(state.step), dense_leaves=dense, adam=(count, mu, nu),
                 emb_tables=_canonical_tables(jeng, state.emb_params),
                 emb_acc={"emb/emb/d17": acc})
    port = train_state_from_jax(eng, device="cpu", **start)
    batch_list = [next(batches) for _ in range(STEPS)]
    losses = []
    for b in batch_list:
        state, jm = step(state, jnp.asarray(b.dense), jnp.asarray(b.ids), jnp.asarray(b.labels))
        port, pm = eng.train_step(port, torch.from_numpy(b.dense), torch.from_numpy(b.ids),
                                  torch.from_numpy(b.labels))
        losses.append((float(jm["loss"]), float(pm["loss"])))
        assert pm["overflow"] == 0 and pm["loss"].shape == ()
        if len(losses) == 1:  # copies: later steps update the port's tensors in place
            first = dict(jax=_np_state(jax.device_get(state)),
                         port=jax.tree_util.tree_map(np.copy, _port_np(port)))
    return dict(bf16=bf16, eng=eng, start=start, batches=batch_list, losses=losses,
                first=first, jax=_np_state(jax.device_get(state)), port=_port_np(port),
                port_state=port, acc0=acc)


def test_losses_match_jax(run):
    tol = (0.03 * 2.0 + 1e-3) if run["bf16"] else 1e-6
    for want, got in run["losses"]:
        assert abs(got - want) <= tol, (got, want)


def test_dense_params_and_adam_state_match_jax(run):
    jd, jc, jmu, jnu, _, _ = run["jax"]
    pd, pc, pmu, pnu, _, _ = run["port"]
    assert pc == jc == WARM + STEPS and int(run["port_state"].step) == WARM + STEPS
    if run["bf16"]:
        # the grads are held here through the moments and one step at a time
        # by test_one_step_changes_match_jax; Adam's update of the params is
        # the f32 run's, held tightly below. Near sign(g) where grads are
        # new, it turns bf16 rounding into a sizeable share of a step (20%
        # of the largest on one leaf here), so bf16 params are not compared.
        for moments in ((pmu, jmu), (pnu, jnu)):
            for g, w in zip(*moments):  # bf16-rounded grads feed them: the repo's rule
                assert np.max(np.abs(g - w)) <= 0.03 * np.max(np.abs(w)) + 1e-6
        return
    for got, want in ((pd, jd), (pmu, jmu), (pnu, jnu)):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=F32_TOL["rtol"],
                                       atol=F32_TOL["atol"] * max(np.abs(w).max(), 1e-3))


def test_table_and_acc_match_jax(run):
    *_, jt, ja = run["jax"]
    *_, pt, pa = run["port"]
    untouched = np.all(pa == run["acc0"], axis=1)
    assert 0 < untouched.sum() < len(untouched)
    np.testing.assert_array_equal(pt[untouched], run["start"]["emb_tables"]["emb/emb/d17"][untouched])
    if run["bf16"]:  # held one step at a time by test_one_step_changes_match_jax
        return
    np.testing.assert_allclose(pt, jt, **F32_TOL)
    np.testing.assert_allclose(pa, ja, **F32_TOL)


def test_one_step_changes_match_jax(run):
    """One step from the shared start: each package's change of the touched
    table and acc rows (the embedding columns and the fused wide column
    apart), and the dense grads read off Adam's first moment
    (g = (mu_1 - b1 mu_0) / (1 - b1)), each within STEP_REL_TOL of JAX's
    largest change; untouched rows keep their bits. In bf16 this is where
    the port's backward (Cin2, ProductF32, SplitFusedRows) meets JAX's: the
    CIN's share of the embedding columns' grads cut by a fifth shows as 4%."""
    _check_one_step_changes(run, run["start"]["adam"][1])


def _check_one_step_changes(run, mu0):
    """test_one_step_changes_match_jax's checks; ``mu0`` the dense Adam
    first moments at the shared start."""
    _, _, jmu, _, jt, ja = run["first"]["jax"]
    _, _, pmu, _, pt, pa = run["first"]["port"]
    t0, a0 = run["start"]["emb_tables"]["emb/emb/d17"], run["acc0"]
    touched = np.any(ja != a0, axis=1)
    assert 0 < touched.sum() < len(touched)
    np.testing.assert_array_equal(pt[~touched], t0[~touched])
    np.testing.assert_array_equal(pa[~touched], a0[~touched])
    # the fused wide column's grads outgrow the embedding columns' several
    # times over, so each part is held to its own largest change
    d = t0.shape[1] - 1
    pairs = [(f"{name} {part}", (p - x0)[:, cols], (j - x0)[:, cols])
             for name, p, j, x0 in (("table", pt, jt, t0), ("acc", pa, ja, a0))
             for part, cols in (("embedding columns", slice(0, d)), ("wide column", slice(d, None)))]
    pairs += [(f"dense grad {i}", (p - 0.9 * m0) / 0.1, (j - 0.9 * m0) / 0.1)
              for i, (p, j, m0) in enumerate(zip(pmu, jmu, mu0))]
    for name, got, want in pairs:
        err, scale = np.max(np.abs(got - want)), np.max(np.abs(want))
        assert scale > 0 and err <= STEP_REL_TOL * scale, (name, err, scale)


def test_train_scan_equals_train_steps(run):
    """K ``train_step``s and one ``train_scan`` over the same stacked batches
    give the same states bit for bit (the scan is the same loop)."""
    eng, bs = run["eng"], run["batches"]
    states = [train_state_from_jax(eng, device="cpu", **run["start"]) for _ in range(2)]
    losses = []
    for b in bs:
        states[0], m = eng.train_step(states[0], torch.from_numpy(b.dense),
                                      torch.from_numpy(b.ids), torch.from_numpy(b.labels))
        losses.append(m["loss"])
    stack = [torch.from_numpy(np.stack([getattr(b, k) for b in bs])) for k in ("dense", "ids", "labels")]
    states[1], m = eng.train_scan(states[1], *stack)
    assert m["losses"].shape == (len(bs),) and torch.equal(m["losses"], torch.stack(losses))
    assert torch.equal(m["loss"], losses[-1]) and m["overflow"] == 0
    a, b = (_port_np(s) for s in states)
    for x, y in zip(a, b):
        if isinstance(x, list):
            assert all(np.array_equal(u, v) for u, v in zip(x, y))
        else:
            assert np.array_equal(x, y)


def test_sparse_adam_raises_naming_the_roadmap():
    """Named for the time before lazy Adam was ported: now an engine with
    ``sparse_optimizer="adam"`` builds with lazy Adam (and ``fuse_wide=False``
    keeps the wide column in its own dim-1 table), and only an unknown
    sparse optimizer raises, naming it."""
    tcfg = TrainConfig(**_cfg(True))
    model = build_model("xdeepfm", build_schema(tcfg), **tcfg.model_kwargs())
    eng = Engine(model, sparse_optimizer="adam", fuse_wide=False)
    assert eng.sparse_opt.name == "adam" and eng.sparse_opt.hyper["b1"] == 0.9
    assert {n: [g.name for g in c.groups] for n, c in eng.collections.items()} == {
        "wide": ["d1"], "emb": ["d16"]}
    assert list(Engine(model).collections) == ["emb"]  # fused by default
    with pytest.raises(ValueError, match="no_such_optimizer"):
        Engine(model, sparse_optimizer="no_such_optimizer")


def test_engine_init_fills_optimizer_states():
    tcfg = TrainConfig(**_cfg(True))
    eng = Engine(build_model("xdeepfm", build_schema(tcfg), **tcfg.model_kwargs()))
    st = eng.init(seed=1, device="cpu")
    assert int(st.dense_opt["count"]) == 0
    assert [t.shape for t in st.dense_opt["mu"]] == [t.shape for t in leaves(st.dense_params)]
    acc = st.emb_opt["emb"]["d17"]["acc"]
    assert acc.shape == st.emb_params["emb"]["d17"].shape and torch.all(acc == 0.1)


def test_engine_init_fills_adam_moments():
    tcfg = TrainConfig(**_cfg(True))
    eng = Engine(build_model("xdeepfm", build_schema(tcfg), **tcfg.model_kwargs()),
                 sparse_optimizer="adam", fuse_wide=False)
    st = eng.init(seed=1, device="cpu")
    for coll, group, shape in (("emb", "d16", (2048, 16)), ("wide", "d1", (2048,))):
        table = st.emb_params[coll][group]
        assert table.shape == shape
        opt = st.emb_opt[coll][group]
        assert sorted(opt) == ["m", "v"]
        assert all(t.shape == shape and not t.any() for t in opt.values())


# ----------------------------------------------------------------- slice 3
GROUPS3 = (("emb", "d16"), ("wide", "d1"))


def _cfg3(bf16: bool) -> dict:
    return dict(model="xdeepfm", vocab_size=50, embed_dim=16, cin_sizes=(128, 128, 128),
                hidden=(64, 64), bf16=bf16)


def _np_state3(state):
    """(dense leaves, Adam count, mu, nu, {(coll, group): (table, m, v)})
    of a JAX state."""
    adam = state.dense_opt[0]
    tabs = {(c, g): tuple(np.asarray(x) for x in (state.emb_params[c][g], state.emb_opt[c][g]["m"],
                                                   state.emb_opt[c][g]["v"])) for c, g in GROUPS3}
    return ([np.asarray(x) for x in jax.tree_util.tree_leaves(state.dense_params)], int(adam.count),
            [np.asarray(x) for x in jax.tree_util.tree_leaves(adam.mu)],
            [np.asarray(x) for x in jax.tree_util.tree_leaves(adam.nu)], tabs)


def _port_np3(state):
    tabs = {(c, g): tuple(x.numpy().copy() for x in (state.emb_params[c][g], state.emb_opt[c][g]["m"],
                                                      state.emb_opt[c][g]["v"])) for c, g in GROUPS3}
    return ([t.numpy().copy() for t in leaves(state.dense_params)], int(state.dense_opt["count"]),
            [t.numpy().copy() for t in state.dense_opt["mu"]],
            [t.numpy().copy() for t in state.dense_opt["nu"]], tabs)


@pytest.fixture(scope="module", params=[False, True], ids=["f32", "bf16"])
def run3(request):
    """Both packages from one mid-training lazy-Adam state through the same
    batches, on the slice-3 path (3-layer CIN, unfused wide table)."""
    bf16 = request.param
    jcfg = JConfig(**_cfg3(bf16))
    schema = jbuild_schema(jcfg)
    jeng = JEngine(jbuild_model("xdeepfm", schema, **jcfg.model_kwargs()), dense_lr=DENSE_LR,
                   emb_lr=EMB_LR, sparse_optimizer="adam", fuse_wide=False)
    step = jax.jit(jeng.train_step)
    state = jeng.init(jax.random.key(0))
    batches = iter(SyntheticSource(schema, batch_size=64, seed=1))
    for _ in range(WARM):  # the moments move off their zeros
        b = next(batches)
        state, _ = step(state, jnp.asarray(b.dense), jnp.asarray(b.ids), jnp.asarray(b.labels))
    state = jax.device_get(state)
    dense, count, mu, nu, tabs = _np_state3(state)
    tcfg = TrainConfig(**_cfg3(bf16))
    eng = Engine(build_model("xdeepfm", build_schema(tcfg), **tcfg.model_kwargs()),
                 dense_lr=DENSE_LR, emb_lr=EMB_LR, sparse_optimizer="adam", fuse_wide=False)
    start = dict(step=int(state.step), dense_leaves=dense, adam=(count, mu, nu),
                 emb_tables=_canonical_tables(jeng, state.emb_params),
                 emb_opt={f"emb/{c}/{g}": {"m": tabs[c, g][1], "v": tabs[c, g][2]} for c, g in GROUPS3})
    port = train_state_from_jax(eng, device="cpu", **start)
    losses = []
    for k in range(STEPS):
        b = next(batches)
        state, jm = step(state, jnp.asarray(b.dense), jnp.asarray(b.ids), jnp.asarray(b.labels))
        port, pm = eng.train_step(port, torch.from_numpy(b.dense), torch.from_numpy(b.ids),
                                  torch.from_numpy(b.labels))
        losses.append((float(jm["loss"]), float(pm["loss"])))
        if k == 0:
            first = dict(jax=_np_state3(jax.device_get(state)), port=_port_np3(port))
    return dict(bf16=bf16, start=(dense, count, mu, nu, tabs), losses=losses, first=first,
                jax=_np_state3(jax.device_get(state)), port=_port_np3(port), port_state=port)


def test_slice3_losses_match_jax(run3):
    tol = (0.03 * 2.0 + 1e-3) if run3["bf16"] else 1e-6
    for want, got in run3["losses"]:
        assert abs(got - want) <= tol, (got, want)


def test_slice3_dense_params_and_adam_state_match_jax(run3):
    jd, jc, jmu, jnu, _ = run3["jax"]
    pd, pc, pmu, pnu, _ = run3["port"]
    assert pc == jc == WARM + STEPS and int(run3["port_state"].step) == WARM + STEPS
    pairs = [(pmu, jmu), (pnu, jnu)] + ([] if run3["bf16"] else [(pd, jd)])
    for got, want in pairs:
        for g, w in zip(got, want):
            if run3["bf16"]:  # bf16-rounded grads feed the moments: the repo's rule
                assert np.max(np.abs(g - w)) <= 0.03 * np.max(np.abs(w)) + 1e-6
            else:
                np.testing.assert_allclose(g, w, rtol=F32_TOL["rtol"],
                                           atol=F32_TOL["atol"] * max(np.abs(w).max(), 1e-3))


def test_slice3_tables_and_moments_match_jax(run3):
    """After the three steps: rows no step touched keep their bits in
    table, m and v; f32 tables and moments to rounding order, bf16 moments
    by the repo's rule (the bf16 tables: one step at a time below)."""
    start, jtabs, ptabs = run3["start"][4], run3["jax"][4], run3["port"][4]
    for key in GROUPS3:
        t0, m0, v0 = start[key]
        untouched = (jtabs[key][2] == v0).reshape(len(v0), -1).all(1)
        assert 0 < untouched.sum() < len(untouched)
        for got, before in zip(ptabs[key], start[key]):
            np.testing.assert_array_equal(got[untouched], before[untouched])
        for i, (got, want) in enumerate(zip(ptabs[key], jtabs[key])):
            if not run3["bf16"]:
                np.testing.assert_allclose(got, want, **F32_TOL)
            elif i > 0:
                assert np.max(np.abs(got - want)) <= 0.03 * np.max(np.abs(want)), (key, i)


def test_slice3_one_step_changes_match_jax(run3):
    """One step from the shared start, per table: the change of m and v on
    touched rows, and in f32 of the table, within STEP_REL_TOL of JAX's
    largest change; in bf16 the table's change is the Adam step of the
    port's own new moments, bit for bit (module docstring); the dense grads
    read off Adam's first moment as in slice 2; untouched rows keep their
    bits."""
    _, _, jmu, _, jtabs = run3["first"]["jax"]
    _, _, pmu, _, ptabs = run3["first"]["port"]
    _, _, mu0, _, start = run3["start"]
    c = adam_constants(0.9, 0.999, 1e-8)
    lr, bc1, bc2 = adam_scalars(torch.tensor(EMB_LR), torch.tensor(WARM, dtype=torch.int32),
                                0.9, 0.999).unbind()
    pairs = [(f"dense grad {i}", (p - 0.9 * m0) / 0.1, (j - 0.9 * m0) / 0.1)
             for i, (p, j, m0) in enumerate(zip(pmu, jmu, mu0))]
    for key in GROUPS3:
        v0 = start[key][2]
        touched = (jtabs[key][2] != v0).reshape(len(v0), -1).any(1)
        assert 0 < touched.sum() < len(touched)
        for got, before in zip(ptabs[key], start[key]):
            np.testing.assert_array_equal(got[~touched], before[~touched])
        for i, name in enumerate(("table", "m", "v")):
            if name != "table" or not run3["bf16"]:
                pairs.append((f"{key} {name}", (ptabs[key][i] - start[key][i])[touched],
                              (jtabs[key][i] - start[key][i])[touched]))
        if run3["bf16"]:
            m1, v1 = (torch.from_numpy(x[touched]) for x in ptabs[key][1:])
            adam_step = -lr * (m1 / bc1) / (torch.sqrt((v1 / bc2).double()).float() + c["eps"])
            want = torch.from_numpy(start[key][0][touched]) + adam_step
            np.testing.assert_array_equal(ptabs[key][0][touched], want.numpy())
    for name, got, want in pairs:
        err, scale = np.max(np.abs(got - want)), np.max(np.abs(want))
        assert scale > 0 and err <= STEP_REL_TOL * scale, (name, err, scale)


# ------------------------------------------- slice 7: schedules and decay
SCHED = dict(kind="cosine", warmup_steps=2, total_steps=8, end_scale=0.1)
DECAY = 1e-2


@pytest.fixture(scope="module", params=[False, True], ids=["f32", "bf16"])
def run_sched(request):
    """``run``'s model and batches with both lrs on a cosine schedule with
    warmup and adamw's decay on the dense weights: two JAX steps (the
    warmup), the state carried into the port with optax's whole dense state
    (adamw's chain and the schedule's count), then three steps in each."""
    from recmodels_tpu.train.schedules import build_lr_schedule as jbuild_lr
    from recmodels_tpu_torch.train.schedules import build_lr_schedule
    from torch_jax_bridge import port_state_from_jax

    bf16 = request.param
    jcfg = JConfig(**_cfg(bf16))
    schema = jbuild_schema(jcfg)
    jeng = JEngine(jbuild_model("xdeepfm", schema, **jcfg.model_kwargs()), dense_lr=DENSE_LR,
                   emb_lr=EMB_LR, dense_lr_schedule=jbuild_lr(DENSE_LR, **SCHED),
                   emb_lr_schedule=jbuild_lr(EMB_LR, **SCHED), dense_weight_decay=DECAY)
    step = jax.jit(jeng.train_step)
    state = jeng.init(jax.random.key(0))
    batches = iter(SyntheticSource(schema, batch_size=64, seed=1))
    for _ in range(WARM):
        b = next(batches)
        state, _ = step(state, jnp.asarray(b.dense), jnp.asarray(b.ids), jnp.asarray(b.labels))
    state = jax.device_get(state)
    dense, count, mu, nu, table, acc = _np_state(state)
    tcfg = TrainConfig(**_cfg(bf16))
    eng = Engine(build_model("xdeepfm", build_schema(tcfg), **tcfg.model_kwargs()), dense_lr=DENSE_LR,
                 emb_lr=EMB_LR, dense_lr_schedule=build_lr_schedule(DENSE_LR, **SCHED),
                 emb_lr_schedule=build_lr_schedule(EMB_LR, **SCHED), dense_weight_decay=DECAY)
    port = port_state_from_jax(jeng, state, eng)
    assert int(port.dense_opt["schedule_count"]) == WARM and int(port.dense_opt["count"]) == WARM
    losses = []
    for k in range(STEPS):
        b = next(batches)
        state, jm = step(state, jnp.asarray(b.dense), jnp.asarray(b.ids), jnp.asarray(b.labels))
        port, pm = eng.train_step(port, torch.from_numpy(b.dense), torch.from_numpy(b.ids),
                                  torch.from_numpy(b.labels))
        losses.append((float(jm["loss"]), float(pm["loss"])))
        if k == 0:
            first = dict(jax=_np_state(jax.device_get(state)),
                         port=jax.tree_util.tree_map(np.copy, _port_np(port)))
    state = jax.device_get(state)
    return dict(bf16=bf16, start=dict(emb_tables={"emb/emb/d17": table}), mu0=mu, acc0=acc,
                losses=losses, first=first, jax=_np_state(state), port=_port_np(port), port_state=port,
                jax_schedule_count=int(state.dense_opt[2].count))


def test_scheduled_decayed_steps_match_jax(run_sched):
    """Three steps on schedules with adamw's decay, as
    ``test_losses_match_jax``, ``test_dense_params_and_adam_state_match_jax``
    and ``test_table_and_acc_match_jax`` hold the constant-lr steps; both
    schedule counts and the step advance to WARM + STEPS."""
    r = run_sched
    tol = (0.03 * 2.0 + 1e-3) if r["bf16"] else 1e-6
    for want, got in r["losses"]:
        assert abs(got - want) <= tol, (got, want)
    st = r["port_state"]
    assert (int(st.step) == int(st.dense_opt["count"]) == int(st.dense_opt["schedule_count"])
            == r["jax_schedule_count"] == WARM + STEPS)
    jd, _, jmu, jnu, jt, ja = r["jax"]
    pd, _, pmu, pnu, pt, pa = r["port"]
    if r["bf16"]:
        for g, w in zip(pmu + pnu, jmu + jnu):
            assert np.max(np.abs(g - w)) <= 0.03 * np.max(np.abs(w)) + 1e-6
        return
    for got, want in ((pd, jd), (pmu, jmu), (pnu, jnu)):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=F32_TOL["rtol"],
                                       atol=F32_TOL["atol"] * max(np.abs(w).max(), 1e-3))
    np.testing.assert_allclose(pt, jt, **F32_TOL)
    np.testing.assert_allclose(pa, ja, **F32_TOL)


def test_scheduled_decayed_one_step_changes_match_jax(run_sched):
    """The first scheduled step from the shared start, held as
    ``test_one_step_changes_match_jax`` holds a constant-lr one (the dense
    grads read off Adam's first moment, which no lr or decay touches)."""
    _check_one_step_changes(run_sched, run_sched["mu0"])


# ------------------------------------------- slice 7: gradient accumulation
def _accum_engines(sparse_opt: str):
    """The JAX package's accumulation test's setup
    (``tests/test_train_loop.py::test_grad_accumulation_matches_full_batch``):
    DeepFM DNN(32) over 26 slots of 500 ids, dim 8, both engines."""
    from recmodels_tpu.data import criteo_schema as jcriteo_schema
    from recmodels_tpu_torch.data import criteo_schema

    kw = dict(dense_lr=1e-2, emb_lr=5e-2, sparse_optimizer=sparse_opt)
    jsch = jcriteo_schema(vocab_size=500, embed_dim=8)
    jeng = JEngine(jbuild_model("deepfm", jsch, hidden=(32,)), **kw)
    eng = Engine(build_model("deepfm", criteo_schema(vocab_size=500, embed_dim=8), hidden=(32,)), **kw)
    return jsch, jeng, eng


# the JAX package's bound for accumulated against full-batch steps
# (tests/test_train_loop.py:90): lazy Adam's 1/(sqrt(v) + eps) turns
# summation-order ulps on near-zero-v rows into up to 0.3% of an element;
# a wrong 1/A or a dropped micro-batch moves everything by 50% or more
ACCUM_TOL = dict(rtol=5e-3, atol=1e-4)


# against JAX's accumulated step: the moments and Adagrad's tables, which
# carry the grads, to f32 rounding of their largest value; what an Adam step
# moves (the dense params; lazy Adam's table) to 1e-3 of a step a step:
# Adam normalises each grad by its own history, so an element whose grad
# nearly cancels turns summation-order ulps into a share of its step (2.4e-4
# of a step seen on DeepFM's first MLP weight after 3 steps)
MOMENT_TOL = 1e-6
ADAM_STEP_TOL = 1e-3


@pytest.mark.parametrize("sparse_opt", ["adagrad", "adam"])
def test_train_step_accum_matches_jax_and_the_full_batch(sparse_opt):
    """Three ``train_step_accum``s of two micro-batches of 32 from JAX's
    initial state: the losses and the state against JAX's
    ``train_step_accum`` on the same batches (f32, the same formulas in
    another summation order; MOMENT_TOL and ADAM_STEP_TOL), and against the
    port's ``train_step`` on the concatenated batch within ACCUM_TOL."""
    from torch_jax_bridge import port_arrays, port_names, port_state_from_jax

    jsch, jeng, eng = _accum_engines(sparse_opt)
    jstate = jeng.init(jax.random.key(0))
    accum, full = port_state_from_jax(jeng, jstate, eng), port_state_from_jax(jeng, jstate, eng)
    jaccum = jax.jit(jeng.train_step_accum)
    src = iter(SyntheticSource(jsch, batch_size=64, seed=1))
    steps = 3
    for _ in range(steps):
        b = next(src)
        d, i, l = (x.reshape(2, 32, *x.shape[1:]) for x in (b.dense, b.ids, b.labels))
        jstate, jm = jaccum(jstate, jnp.asarray(d), jnp.asarray(i), jnp.asarray(l))
        accum, am = eng.train_step_accum(accum, *(torch.from_numpy(x) for x in (d, i, l)))
        full, fm = eng.train_step(full, *(torch.from_numpy(x) for x in (b.dense, b.ids, b.labels)))
        assert am["overflow"] == 0 and am["loss"].shape == ()
        np.testing.assert_allclose(float(am["loss"]), float(jm["loss"]), rtol=1e-6)
        np.testing.assert_allclose(float(am["loss"]), float(fm["loss"]), rtol=1e-5)
    assert int(accum.step) == steps
    want = port_arrays(port_state_from_jax(jeng, jstate, eng))
    for name, got, w, f in zip(port_names(accum), port_arrays(accum), want, port_arrays(full)):
        got, w, f = (x.astype(np.float64) for x in (got, w, f))
        if name.startswith("dense_params/"):
            atol = ADAM_STEP_TOL * eng.dense_lr * steps
        elif name.startswith("emb_params/") and sparse_opt == "adam":
            atol = ADAM_STEP_TOL * eng.emb_lr * steps
        else:
            atol = MOMENT_TOL * np.abs(w).max()
        assert np.abs(got - w).max() <= atol, (name, np.abs(got - w).max(), atol)
        np.testing.assert_allclose(got, f, **ACCUM_TOL, err_msg=name)


def test_train_step_accum_shares_one_concatenation(monkeypatch):
    """Collections over one ids tensor (slice 3's dim-16 and dim-1 tables)
    hand the update one concatenated ids tensor, so it sorts once."""
    tcfg = TrainConfig(**_cfg3(False))
    eng = Engine(build_model("xdeepfm", build_schema(tcfg), **tcfg.model_kwargs()),
                 sparse_optimizer="adam", fuse_wide=False)
    state = eng.init(seed=0, device="cpu")
    seen = []
    apply_grads = eng.tables.apply_grads

    def spy(emb_params, emb_opt, gids, grad_rows, step, lr):
        seen.append(gids)
        return apply_grads(emb_params, emb_opt, gids, grad_rows, step, lr)

    monkeypatch.setattr(eng.tables, "apply_grads", spy)
    b = next(iter(SyntheticSource(jbuild_schema(JConfig(**_cfg3(False))), batch_size=16, seed=3)))
    d, i, l = (torch.from_numpy(x.reshape(2, 8, *x.shape[1:])) for x in (b.dense, b.ids, b.labels))
    eng.train_step_accum(state, d, i, l)
    (gids,) = seen
    assert gids["emb"]["d16"] is gids["wide"]["d1"] and gids["emb"]["d16"].shape == (16, 26)
