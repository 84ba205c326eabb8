"""The model zoo as a whole on the CPU against the JAX package: small
models (26 slots of a 50-id vocab, so ids repeat; dim 16; DNN(64, 64); AFM's
attention of 8; batch 64) trained two steps in JAX, carried into the port by
``serve.train_state_from_jax`` (and by ``serve.params_from_jax`` for the
forward), then three ``train_step``s in both packages on the same batches,
with the engine's defaults: dense Adam at lr 1e-3, sparse Adagrad at lr
1e-2. FM, DeepFM, Wide&Deep, NFM and AFM take the fused wide column (a
table of dim 17, the model given the view ``full[..., :16]`` and the f32
wide column); DCN and PNN (mode ``both``) one ``emb`` table of dim 16; LR
only the dim-1 ``wide`` table, stored 1-D and gathered in f32. FM and LR
compute in f32 only. PNN's ``inner`` and ``outer`` modes are held by their
forward alone.

Tolerances:
* f32: both packages run the same math in another summation order: logits,
  losses, params, Adam's moments, the table and acc to rtol 1e-5.
* bf16 (DeepFM and DCN): JAX runs its kernel entries there
  (``interactions_tpu.fm_pairwise``/``dcn_cross_stack`` in interpret mode,
  with the custom VJPs ``_fm_bwd``/``_dcn_bwd`` that the port's backwards
  follow); its default route differentiates the reference, which rounds the
  backward at other points: for the cross stack at B = 64, d = 429, JAX's
  autodiff puts gb 0.9% of its largest value off the f32 oracle, the custom
  VJP (and the port, bit for bit) 0.35%; in one DCN step the two JAX routes'
  cross/b grads differ by 6% of the largest. Forward, both routes are one
  function. The f32 cases run JAX's default route. Beyond that, XLA may
  keep f32 between fused bf16 steps and sums in another order, so a bf16
  value (an MLP activation, t of a cross layer, the FM term, the MLP's
  output, an inner product, an attention score) may round one step (2^-8)
  apart; the backwards of PNN's inner products and AFM's pair products sum
  each field's grad in f32 and round once, where JAX's autodiff rounds each
  of the terms it adds.
  - logits: the repo's bf16 rule, 0.03 * max |logit| + 1e-3;
  - losses: BCE is 1-Lipschitz in each logit, so the same bound with the
    logits of these models below 2: 0.03 * 2 + 1e-3;
  - Adam's moments after three steps: 3% of the largest |value| (the
    bf16-rounded grads feed them);
  - one step from the shared start: the change of the touched table and acc
    rows (the embedding columns and the fused wide column apart), and the
    dense grads read off Adam's first moment, within 3% of JAX's largest
    change. The grad of a one-element leaf (the model's bias, the MLP's
    output bias) is the batch mean of sigmoid(z) - y, which cancels; a
    logit z that differs by dz moves it by at most |dz| / (4 B), so it is
    held to 3% of its value plus a quarter of the mean |dz| between the
    packages' logits on that step's batch. After that step the bf16 states differ by such roundings and
    Adam turns them into steps of their own (near sign(g) where grads are
    new), so params, table and acc are compared one step at a time, as
    ``tests/test_torch_train.py`` does for xDeepFM.
  - untouched rows (those no batch id names) keep their bits after one step
    and after three.
  - AFM: at the start its embedding grads are too small to move acc (their
    squares lie under half an ulp of it), so acc's embedding columns must
    keep their bits in both packages; its table moves there by some thirty
    f32 ulps, so one ulp of the largest touched row is added to that part's
    tolerance (each package rounds the updated row once).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recmodels_tpu.data import SyntheticSource
from recmodels_tpu.ops import dispatch as jdispatch
from recmodels_tpu.ops.pallas import interactions_tpu as JT
from recmodels_tpu.models import build_model as jbuild_model
from recmodels_tpu.serve import _canonical_tables
from recmodels_tpu.train.engine import Engine as JEngine
from recmodels_tpu.train.loop import build_schema as jbuild_schema
from recmodels_tpu.utils.config import TrainConfig as JConfig
from recmodels_tpu_torch.models import build_model
from recmodels_tpu_torch.serve import params_from_jax, train_state_from_jax
from recmodels_tpu_torch.train.engine import Engine
from recmodels_tpu_torch.utils.config import TrainConfig, build_schema
from recmodels_tpu_torch.utils.tree import leaves

DENSE_LR, EMB_LR = 1e-3, 1e-2
WARM, STEPS = 2, 3
F32_TOL = dict(rtol=1e-5, atol=1e-6)
STEP_REL_TOL = 0.03
ZOO = ("lr", "pnn", "widedeep", "nfm", "afm")  # the models of slice 6
CASES = [("fm", False), ("deepfm", False), ("deepfm", True), ("dcn", False), ("dcn", True),
         ("lr", False)] + [(m, bf16) for m in ZOO[1:] for bf16 in (False, True)]
IDS = [f"{m}-{'bf16' if bf16 else 'f32'}" for m, bf16 in CASES]


def _cfg(model: str, bf16: bool, **kw) -> dict:
    return dict(model=model, vocab_size=50, embed_dim=16, hidden=(64, 64), attention_dim=8,
                bf16=bf16, **kw)


def _table(state_emb, coll, group):
    """A table or state of one group as [rows, dim] (dim-1 tables are 1-D)."""
    t = np.asarray(state_emb[coll][group])
    return t.reshape(t.shape[0], -1)


def _np_state(state, coll, group):
    """(dense leaves, Adam count, mu, nu, table, acc) of a JAX state."""
    adam = state.dense_opt[0]
    acc = {c: {g: s["acc"] for g, s in gs.items()} for c, gs in state.emb_opt.items()}
    return ([np.asarray(x) for x in jax.tree_util.tree_leaves(state.dense_params)], int(adam.count),
            [np.asarray(x) for x in jax.tree_util.tree_leaves(adam.mu)],
            [np.asarray(x) for x in jax.tree_util.tree_leaves(adam.nu)],
            _table(state.emb_params, coll, group), _table(acc, coll, group))


def _port_np(state, coll, group):
    acc = {c: {g: s["acc"].numpy() for g, s in gs.items()} for c, gs in state.emb_opt.items()}
    return ([t.numpy().copy() for t in leaves(state.dense_params)], int(state.dense_opt["count"]),
            [t.numpy().copy() for t in state.dense_opt["mu"]],
            [t.numpy().copy() for t in state.dense_opt["nu"]],
            _table({coll: {group: state.emb_params[coll][group].numpy()}}, coll, group).copy(),
            _table(acc, coll, group).copy())


@pytest.fixture(scope="module", params=CASES, ids=IDS)
def run(request):
    """Both packages from one mid-training state through the same batches;
    bf16 JAX on its kernel entries (module docstring)."""
    model, bf16 = request.param
    with pytest.MonkeyPatch.context() as mp:
        if bf16:
            mp.setattr(JT, "_INTERPRET", True)
            mp.setattr(jdispatch, "_pallas_enabled", lambda: True)
            mp.setitem(jdispatch._PALLAS, "fm_pairwise", JT.fm_pairwise)
            mp.setitem(jdispatch._PALLAS, "dcn_cross_stack", JT.dcn_cross_stack)
        return _run(model, bf16)


def _run(model: str, bf16: bool) -> dict:
    jcfg = JConfig(**_cfg(model, bf16))
    schema = jbuild_schema(jcfg)
    jeng = JEngine(jbuild_model(model, schema, **jcfg.model_kwargs()), dense_lr=DENSE_LR, emb_lr=EMB_LR)
    step = jax.jit(jeng.train_step)
    state = jeng.init(jax.random.key(0))
    batches = iter(SyntheticSource(schema, batch_size=64, seed=1))
    for _ in range(WARM):  # the wide column, the moments and acc move off their init
        b = next(batches)
        state, _ = step(state, jnp.asarray(b.dense), jnp.asarray(b.ids), jnp.asarray(b.labels))
    state = jax.device_get(state)
    ((coll, groups),) = state.emb_params.items()  # one collection, one group
    (group,) = groups
    dense, count, mu, nu, _, acc = _np_state(state, coll, group)
    tcfg = TrainConfig(**_cfg(model, bf16))
    eng = Engine(build_model(model, build_schema(tcfg), **tcfg.model_kwargs()),
                 dense_lr=DENSE_LR, emb_lr=EMB_LR)
    tables = _canonical_tables(jeng, state.emb_params)
    start = dict(step=int(state.step), dense_leaves=dense, adam=(count, mu, nu), emb_tables=tables,
                 emb_acc={f"emb/{coll}/{group}": np.asarray(state.emb_opt[coll][group]["acc"])})
    # the forward from the same weights, on a batch no step sees
    fb = next(iter(SyntheticSource(schema, batch_size=64, seed=9)))
    logits = dict(jax=np.asarray(jax.jit(jeng.logits)(state, jnp.asarray(fb.dense), jnp.asarray(fb.ids))))
    served = params_from_jax(eng, dense, tables, device="cpu")
    with torch.inference_mode():
        logits["port"] = eng.logits(served, torch.from_numpy(fb.dense), torch.from_numpy(fb.ids)).numpy()
    port = train_state_from_jax(eng, device="cpu", **start)
    losses, batch_list = [], []
    for k in range(STEPS):
        b = next(batches)
        batch_list.append(b)
        if k == 0:  # the packages' logits on the first step's batch, from the shared start
            jz = np.asarray(jax.jit(jeng.logits)(state, jnp.asarray(b.dense), jnp.asarray(b.ids)))
            with torch.inference_mode():
                pz = eng.logits(port, torch.from_numpy(b.dense), torch.from_numpy(b.ids)).numpy()
            dz = float(np.mean(np.abs(pz - jz)))
        state, jm = step(state, jnp.asarray(b.dense), jnp.asarray(b.ids), jnp.asarray(b.labels))
        port, pm = eng.train_step(port, torch.from_numpy(b.dense), torch.from_numpy(b.ids),
                                  torch.from_numpy(b.labels))
        losses.append((float(jm["loss"]), float(pm["loss"])))
        assert pm["overflow"] == 0 and pm["loss"].shape == ()
        if k == 0:
            first = dict(jax=_np_state(jax.device_get(state), coll, group), port=_port_np(port, coll, group))
    return dict(model=model, bf16=bf16, coll=coll, group=group, eng=eng, batches=batch_list, start=start,
                acc0=acc, logits=logits, dz=dz, losses=losses, first=first,
                jax=_np_state(jax.device_get(state), coll, group), port=_port_np(port, coll, group),
                port_state=port)


def _touched(run, steps: int) -> np.ndarray:
    """[rows] bool: the rows the ids of the first ``steps`` batches name (an
    id's acc may stay put where its grad's square is under an ulp of acc,
    as for AFM's embedding columns at init, so acc does not tell)."""
    coll = run["eng"].collections[run["coll"]]
    touched = np.zeros(_start_table(run).shape[0], bool)
    for b in run["batches"][:steps]:
        touched[coll.group_row_ids(torch.from_numpy(b.ids))[run["group"]].numpy().reshape(-1)] = True
    return touched


def _start_table(run):
    t = run["start"]["emb_tables"][f"emb/{run['coll']}/{run['group']}"]
    return t.reshape(t.shape[0], -1)


def test_forward_matches_jax(run):
    got, want = run["logits"]["port"], run["logits"]["jax"]
    assert got.shape == want.shape == (64,) and got.dtype == np.float32
    if run["bf16"]:
        assert np.max(np.abs(got - want)) <= 0.03 * np.max(np.abs(want)) + 1e-3
    else:
        np.testing.assert_allclose(got, want, rtol=F32_TOL["rtol"], atol=1e-5)


def test_losses_match_jax(run):
    tol = (0.03 * 2.0 + 1e-3) if run["bf16"] else 1e-6
    for want, got in run["losses"]:
        assert abs(got - want) <= tol, (got, want)


def test_dense_params_and_adam_state_match_jax(run):
    jd, jc, jmu, jnu, _, _ = run["jax"]
    pd, pc, pmu, pnu, _, _ = run["port"]
    assert pc == jc == WARM + STEPS and int(run["port_state"].step) == WARM + STEPS
    assert [x.shape for x in pd] == [x.shape for x in jd]
    pairs = [(pmu, jmu), (pnu, jnu)] + ([] if run["bf16"] else [(pd, jd)])
    for got, want in pairs:
        for g, w in zip(got, want):
            if run["bf16"]:  # bf16-rounded grads feed the moments: the repo's rule
                assert np.max(np.abs(g - w)) <= 0.03 * np.max(np.abs(w)) + 1e-6
            else:
                np.testing.assert_allclose(g, w, rtol=F32_TOL["rtol"],
                                           atol=F32_TOL["atol"] * max(np.abs(w).max(), 1e-3))


def test_table_and_acc_match_jax(run):
    *_, jt, ja = run["jax"]
    *_, pt, pa = run["port"]
    t0 = _start_table(run)
    untouched = ~_touched(run, STEPS)
    assert 0 < untouched.sum() < len(untouched)
    np.testing.assert_array_equal(pt[untouched], t0[untouched])
    np.testing.assert_array_equal(pa[untouched], run["acc0"][untouched])
    if run["bf16"]:  # held one step at a time by test_one_step_changes_match_jax
        return
    np.testing.assert_allclose(pt, jt, **F32_TOL)
    np.testing.assert_allclose(pa, ja, **F32_TOL)


def test_one_step_changes_match_jax(run):
    """One step from the shared start: each package's change of the touched
    table and acc rows (for the models with a fused table the embedding
    columns and the fused wide column apart), and the dense grads read off Adam's first
    moment (g = (mu_1 - b1 mu_0) / (1 - b1)), each within STEP_REL_TOL of
    JAX's largest change; untouched rows keep their bits. This is where the
    port's backward (``FmPairwise``, ``DcnCrossStack``, ``ProductF32``,
    ``AfmPairProducts`` and autograd's through the other ops) meets JAX's."""
    _, _, jmu, _, jt, ja = run["first"]["jax"]
    _, _, pmu, _, pt, pa = run["first"]["port"]
    mu0 = run["start"]["adam"][1]
    t0, a0 = _start_table(run), run["acc0"]
    touched = _touched(run, 1)
    assert 0 < touched.sum() < len(touched)
    np.testing.assert_array_equal(pt[~touched], t0[~touched])
    np.testing.assert_array_equal(pa[~touched], a0[~touched])
    # the fused wide column's grads differ in size from the embedding
    # columns', so each part is held to its own largest change
    d = 16
    parts = [("embedding columns", slice(0, d))] + ([("wide column", slice(d, None))]
                                                    if t0.shape[1] > d else [])
    pairs = [(f"{name} {part}", (p - x0)[:, cols], (j - x0)[:, cols])
             for name, p, j, x0 in (("table", pt, jt, t0), ("acc", pa, ja, a0)) for part, cols in parts]
    pairs += [(f"dense grad {i}", (p - 0.9 * m0) / 0.1, (j - 0.9 * m0) / 0.1)
              for i, (p, j, m0) in enumerate(zip(pmu, jmu, mu0))]
    # AFM's embedding grads at the start are tiny (rows N(0, 0.05), so pair
    # products near 2.5e-3, each pair's attention near 1/325, a mean over
    # 64 examples): their squares lie under half an ulp of acc, whose
    # embedding columns then keep their bits in both packages, and its
    # table's change in them is some thirty f32 ulps of the rows it changes:
    # the rounding of each package's updated row (half an ulp each) is held
    # apart, one ulp of the largest such row
    still = {"acc embedding columns"} if run["model"] == "afm" else set()
    row_ulp = {"table embedding columns": float(np.spacing(np.abs(t0[touched, :d]).max()))
               if run["model"] == "afm" else 0.0}
    for name, got, want in pairs:
        err, scale = np.max(np.abs(got - want)), np.max(np.abs(want))
        tol = STEP_REL_TOL * scale + (run["dz"] / 4 if want.size == 1 else 0.0) + row_ulp.get(name, 0.0)
        if name in still:
            assert scale == 0 and err == 0, (name, err, scale)
            continue
        assert scale > 0 and err <= tol, (name, err, scale, tol)


def test_train_scan_equals_train_steps(run):
    """``train_scan`` over the three stacked batches gives the states and
    losses of the three ``train_step``s bit for bit (it is the same loop)."""
    eng, bs = run["eng"], run["batches"]
    state = train_state_from_jax(eng, device="cpu", **run["start"])
    stack = [torch.from_numpy(np.stack([getattr(b, k) for b in bs])) for k in ("dense", "ids", "labels")]
    state, m = eng.train_scan(state, *stack)
    assert m["losses"].shape == (STEPS,) and m["overflow"] == 0
    assert [float(x) for x in m["losses"]] == [got for _, got in run["losses"]]
    for x, y in zip(_port_np(state, run["coll"], run["group"]), run["port"]):
        if isinstance(x, list):
            assert all(np.array_equal(u, v) for u, v in zip(x, y))
        else:
            assert np.array_equal(x, y)


@pytest.mark.parametrize("model", ["fm", "deepfm", "dcn"])
def test_model_builds_with_the_jax_parameter_tree(model):
    """The port's init has the JAX model's tree (names, order, shapes), the
    engine's collections are JAX's (FM and DeepFM fuse the wide column into
    a dim-17 table, DCN keeps one dim-16 table), and the train step runs
    through the FM or DCN Function."""
    cfg = _cfg(model, model != "fm")
    jcfg, tcfg = JConfig(**cfg), TrainConfig(**cfg)
    jeng = JEngine(jbuild_model(model, jbuild_schema(jcfg), **jcfg.model_kwargs()))
    eng = Engine(build_model(model, build_schema(tcfg), **tcfg.model_kwargs()))
    st = eng.init(seed=0, device="cpu")
    jst = jeng.init(jax.random.key(0))
    ours = jax.tree_util.tree_map(lambda t: t.numpy(), st.dense_params)
    assert jax.tree_util.tree_structure(ours) == jax.tree_util.tree_structure(jst.dense_params)
    assert [x.shape for x in jax.tree_util.tree_leaves(ours)] == [
        x.shape for x in jax.tree_util.tree_leaves(jst.dense_params)]
    assert {n: [g.name for g in c.groups] for n, c in eng.collections.items()} == {
        n: list(t) for n, t in jst.emb_params.items()}
    b = next(iter(SyntheticSource(build_schema(tcfg), batch_size=8, seed=2)))
    with torch.enable_grad():
        dtype = getattr(eng.model, "compute_dtype", torch.float32)
        rows = torch.zeros((8, 26, 17 if model != "dcn" else 16), dtype=dtype, requires_grad=True)
        emb = ({"emb": rows[..., :16], "wide": rows[..., 16:].float()} if model != "dcn"
               else {"emb": rows})
        out = eng.model.apply(st.dense_params, torch.from_numpy(b.dense), emb)
        assert out.shape == (8,) and out.dtype == torch.float32
        names = []
        fn = out.grad_fn
        seen, todo = set(), [fn]
        while todo:
            f = todo.pop()
            if f is None or f in seen:
                continue
            seen.add(f)
            names.append(f.name())
            todo.extend(n for n, _ in f.next_functions)
    want = "DcnCrossStackBackward" if model == "dcn" else "FmPairwiseBackward"
    assert any(n.startswith(want) for n in names), names


@pytest.mark.parametrize("model", ZOO)
def test_zoo_model_builds_with_the_jax_parameter_tree(model):
    """The port's init of LR, PNN, Wide&Deep, NFM and AFM has the JAX
    model's tree (names, order, shapes), and the engine's collections and
    groups are JAX's: LR one 1-D dim-1 ``wide`` table, PNN one dim-16
    ``emb`` table, the others the fused dim-17 table."""
    cfg = _cfg(model, model != "lr")
    jcfg, tcfg = JConfig(**cfg), TrainConfig(**cfg)
    jeng = JEngine(jbuild_model(model, jbuild_schema(jcfg), **jcfg.model_kwargs()))
    eng = Engine(build_model(model, build_schema(tcfg), **tcfg.model_kwargs()))
    st = eng.init(seed=0, device="cpu")
    jst = jeng.init(jax.random.key(0))
    ours = jax.tree_util.tree_map(lambda t: t.numpy(), st.dense_params)
    assert jax.tree_util.tree_structure(ours) == jax.tree_util.tree_structure(jst.dense_params)
    assert [x.shape for x in jax.tree_util.tree_leaves(ours)] == [
        x.shape for x in jax.tree_util.tree_leaves(jst.dense_params)]
    groups = {n: {g.name: (g.alloc_rows,) if g.dim == 1 else (g.alloc_rows, g.dim) for g in c.groups}
              for n, c in eng.collections.items()}
    assert groups == {n: {g: tuple(np.shape(t)) for g, t in gs.items()} for n, gs in jst.emb_params.items()}
    assert groups == {n: {g: tuple(t.shape) for g, t in gs.items()} for n, gs in st.emb_params.items()}
    assert list(groups) == {"lr": ["wide"]}.get(model, ["emb"])


@pytest.mark.parametrize("mode", ["inner", "outer"])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_pnn_modes_forward_matches_jax(mode, bf16):
    """PNN's other modes (the trained cases run ``both``): one JAX state
    carried over by ``params_from_jax``, the port's logits against JAX's
    jitted ones on a batch of 64 (f32 to rtol 1e-5, bf16 by the repo's
    rule)."""
    cfg = _cfg("pnn", bf16, pnn_mode=mode)
    jcfg = JConfig(**cfg)
    schema = jbuild_schema(jcfg)
    jeng = JEngine(jbuild_model("pnn", schema, **jcfg.model_kwargs()), dense_lr=DENSE_LR, emb_lr=EMB_LR)
    state = jax.device_get(jeng.init(jax.random.key(3)))
    tcfg = TrainConfig(**cfg)
    eng = Engine(build_model("pnn", build_schema(tcfg), **tcfg.model_kwargs()))
    assert eng.model.mode == mode
    served = params_from_jax(eng, [np.asarray(x) for x in jax.tree_util.tree_leaves(state.dense_params)],
                             _canonical_tables(jeng, state.emb_params), device="cpu")
    b = next(iter(SyntheticSource(schema, batch_size=64, seed=9)))
    want = np.asarray(jax.jit(jeng.logits)(state, jnp.asarray(b.dense), jnp.asarray(b.ids)))
    with torch.inference_mode():
        got = eng.logits(served, torch.from_numpy(b.dense), torch.from_numpy(b.ids)).numpy()
    if bf16:
        assert np.max(np.abs(got - want)) <= 0.03 * np.max(np.abs(want)) + 1e-3
    else:
        np.testing.assert_allclose(got, want, rtol=F32_TOL["rtol"], atol=1e-5)


def test_every_model_of_the_zoo_builds():
    """``build_model`` builds the nine models of the JAX registry under the
    same names, and the port's own DLRM-DCNv2 and Wukong beside them, and
    refuses a name it does not know."""
    from recmodels_tpu.models import MODEL_REGISTRY as JREGISTRY
    from recmodels_tpu_torch.models import MODEL_REGISTRY

    assert sorted(MODEL_REGISTRY) == sorted([*JREGISTRY, "dlrm_dcnv2", "wukong"]) and len(JREGISTRY) == 9
    schema = build_schema(TrainConfig(vocab_size=50))
    for name in MODEL_REGISTRY:
        # DLRM's and Wukong's bottom MLPs end at the embedding dim (16 here)
        kwargs = {"bottom": (32, 16)} if name in ("dlrm_dcnv2", "wukong") else {}
        assert build_model(name, schema, **kwargs).name == name
    with pytest.raises(KeyError, match="unknown model"):
        build_model("ffm", schema)
