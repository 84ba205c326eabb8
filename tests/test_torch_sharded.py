"""The port's sharded path (``recmodels_tpu_torch/parallel/``) against the
JAX package's ``shard_map`` run at the same world size, on the CPU.

The JAX side runs in this process on ``make_mesh(d)`` of the conftest's 8
fake devices. The port's ranks run in gloo worlds of 2 and 4 processes
(``tests/torch_sharded_worker.py``, which imports no JAX), each world
started once for the module: every rank takes the JAX engine's start state
(``serve.train_state_from_jax``, then ``shard_state``) and the same numpy
batches, and each test asserts on its case. Every case is also held against
the port's own single-device engine (``LocalTables``) in this process.

The cases are ``tests/test_sharded.py``'s five that do not test the TPU's
packed layout (the step against the local oracle for Adagrad and lazy Adam,
eval, overflow counting and zero rows, per-slot dims, scan against
stepwise), plus the step with dense Adam (the owner's sentinel tail) and
the accumulated step (A = 2).

Tolerances are JAX's own (``tests/test_sharded.py``): loss rtol 1e-5;
tables, their optimizer states and the dense state after the steps rtol
1e-4 / atol 1e-5 on the unpadded prefix; AUC atol 1e-6, logloss atol 1e-5.
Both packages compute the same math in other summation orders (per-rank
means, then their mean), so they agree to f32 rounding, which Adam's
normalisation amplifies to a few 1e-6. Overflow counts are exact: the shard
bounds, the capacity and each rank's block of the batch are JAX's.
Overflowed lookups are zero rows; the others are bit for bit the local
gather's. In one process (a gloo world of one) the sharded step equals the
local step bit for bit: the exchange only moves bytes, and the owner's
stream is the local sorted stream plus a sentinel tail.
"""

import copy
import os
import pickle
import socket
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as P

from recmodels_tpu.data import SyntheticSource
from recmodels_tpu.data.schema import criteo_schema as jcriteo_schema
from recmodels_tpu.models import build_model as jbuild_model
from recmodels_tpu.parallel import (
    build_parallel_accum as jbuild_parallel_accum,
    build_parallel_engine as jbuild_parallel_engine,
    build_parallel_scan as jbuild_parallel_scan,
    build_parallel_steps as jbuild_parallel_steps,
    make_mesh as jmake_mesh,
    shard_state as jshard_state,
)
from recmodels_tpu.parallel.sharded_embedding import ShardedTables as JShardedTables
from recmodels_tpu.parallel.train_step import state_specs as jstate_specs
from recmodels_tpu.serve import _canonical_tables
from recmodels_tpu.train.engine import Engine as JEngine
from recmodels_tpu.train.metrics import auc_compute as jauc_compute, auc_init as jauc_init
from recmodels_tpu_torch.data.schema import criteo_schema
from recmodels_tpu_torch.embedding.optim import apply_sorted_updates, dense_adam
from recmodels_tpu_torch.models import build_model
from recmodels_tpu_torch.parallel import (
    DATA_AXIS, Mesh, ShardedTables, build_parallel_engine, build_parallel_steps, make_mesh, shard_state,
    state_specs,
)
from recmodels_tpu_torch.parallel.train_step import REPLICATED, ROWS
from recmodels_tpu_torch.serve import train_state_from_jax
from recmodels_tpu_torch.train.engine import Engine
from recmodels_tpu_torch.train.metrics import AUCState, auc_compute, auc_init
from recmodels_tpu_torch.utils.tree import leaves

try:  # jax >= 0.7 exposes shard_map at top level
    from jax import shard_map as jshard_map
except ImportError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map as jshard_map

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_sharded_worker.py")
WORLD_TIMEOUT_S = 240  # a world that has not finished by then has hung: its tests fail
LOSS_TOL = dict(rtol=1e-5)
STATE_TOL = dict(rtol=1e-4, atol=1e-5)

FM = dict(model="fm", model_kw={}, vocab=500, dims=8, dense_lr=1e-2, emb_lr=5e-2, sparse_opt="adagrad",
          capacity=4.0)
# each case: the engine (a capacity of 4: at this tiny vocab the tables'
# padding skews the shards' loads past the production default's 1.25), the
# JAX key of the start state, the batches as (batch size, stream seed) and
# what the ranks run
CASES = {
    "adagrad": dict(FM, key=0, batches=[(64, 0), (64, 1), (64, 2)], kind="steps"),
    "adam": dict(FM, sparse_opt="adam", key=0, batches=[(64, 0), (64, 1), (64, 2)], kind="steps"),
    "adam_dense": dict(FM, sparse_opt="adam_dense", key=0, batches=[(64, 0), (64, 1), (64, 2)], kind="steps"),
    "eval": dict(FM, model="dcn", model_kw=dict(hidden=(16,), n_cross=2), dense_lr=1e-3, emb_lr=1e-2, key=1,
                 batches=[(128, 9)], kind="eval"),
    "overflow": dict(FM, capacity=0.05, key=0, batches=[(64, 2)], kind="overflow"),
    "per_slot_dims": dict(FM, model="xdeepfm", model_kw=dict(hidden=(16,), cin_sizes=(8,)), vocab=300,
                          dims=[4] * 13 + [8] * 13, dense_lr=1e-3, emb_lr=1e-2, key=3, batches=[(64, 4)],
                          kind="steps"),
    "scan": dict(FM, dense_lr=1e-3, key=5, batches=[(64, 100), (64, 101), (64, 102)], kind="scan"),
    "accum": dict(FM, key=6, batches=[(64, 7)], kind="accum", micro=2),
}
WORLDS = {2: list(CASES), 4: ["adam", "overflow"]}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _schema(spec, jax_side: bool):
    return (jcriteo_schema if jax_side else criteo_schema)(vocab_size=spec["vocab"], embed_dim=spec["dims"])


def _batches(spec) -> list:
    """The case's batches as numpy (dense, ids, labels); accumulated cases
    as [A, Bm, ...]."""
    out = []
    for b, seed in spec["batches"]:
        batch = next(iter(SyntheticSource(_schema(spec, True), batch_size=b, seed=seed)))
        arrays = (batch.dense, batch.ids, batch.labels)
        if "micro" in spec:
            arrays = tuple(a.reshape(spec["micro"], -1, *a.shape[1:]) for a in arrays)
        out.append(arrays)
    return out


def _jax_engine(spec, mesh):
    model = jbuild_model(spec["model"], _schema(spec, True), **spec["model_kw"])
    return jbuild_parallel_engine(model, mesh, dense_lr=spec["dense_lr"], emb_lr=spec["emb_lr"],
                                  sparse_optimizer=spec["sparse_opt"], capacity_factor=spec["capacity"])


def _start_state(spec) -> dict:
    """The JAX sharded engine's start state as numpy arrays, its tables and
    sparse states cut to their canonical rows (the port pads its own)."""
    jeng = _jax_engine(spec, jmake_mesh(2))
    st = jax.device_get(jeng.init(jax.random.key(spec["key"])))
    adam = st.dense_opt[0]
    rows = {f"emb/{c}/{g.name}": g.alloc_rows for c, coll in jeng.collections.items() for g in coll.groups}
    return dict(step=int(st.step), dense=[np.asarray(x) for x in jax.tree_util.tree_leaves(st.dense_params)],
                count=int(adam.count), mu=[np.asarray(x) for x in jax.tree_util.tree_leaves(adam.mu)],
                nu=[np.asarray(x) for x in jax.tree_util.tree_leaves(adam.nu)],
                tables=_canonical_tables(jeng, st.emb_params),
                emb_opt={f"emb/{c}/{g}": {k: np.asarray(v)[: rows[f"emb/{c}/{g}"]] for k, v in s.items()}
                         for c, groups in st.emb_opt.items() for g, s in groups.items()})


def _port_state(engine, st):
    return train_state_from_jax(engine, st["step"], st["dense"], adam=(st["count"], st["mu"], st["nu"]),
                                emb_tables=st["tables"], emb_opt=st["emb_opt"], device="cpu")


def _jax_run(spec, start, batches, d) -> dict:
    """The JAX sharded engine's results on the case at world size ``d``."""
    mesh = jmake_mesh(d)
    jeng = _jax_engine(spec, mesh)
    state = jshard_state(jeng.init(jax.random.key(spec["key"])), mesh)
    out = {}
    kind = spec["kind"]
    if kind == "steps":
        train, _ = jbuild_parallel_steps(jeng, mesh, donate=False)
        ms = []
        for b in batches:
            state, m = train(state, *b)
            ms.append(m)
        out.update(losses=[float(m["loss"]) for m in ms], overflows=[int(m["overflow"]) for m in ms])
    elif kind == "scan":
        state, m = jbuild_parallel_scan(jeng, mesh, donate=False)(state, *(np.stack(x) for x in zip(*batches)))
        out.update(losses=[float(x) for x in m["losses"]], overflow=int(m["overflow"]))
    elif kind == "accum":
        state, m = jbuild_parallel_accum(jeng, mesh, donate=False)(state, *batches[0])
        out.update(losses=[float(m["loss"])], overflows=[int(m["overflow"])])
    elif kind == "eval":
        _, evaluate = jbuild_parallel_steps(jeng, mesh, donate=False)
        auc = jauc_init()
        for b in batches:
            auc = evaluate(state, auc, *b)
        out["auc"] = {k: float(v) for k, v in jauc_compute(auc).items() if k in ("auc", "logloss")}
    elif kind == "overflow":
        def probe(st, ids):
            rows, ovf = jeng.table_strategy.gather_with_stats(st.emb_params, jeng._group_ids(ids))
            return rows, jax.lax.psum(ovf, "data")

        fn = jax.jit(jshard_map(probe, mesh=mesh, in_specs=(jstate_specs(state), P("data")),
                                out_specs=(P("data"), P()), check_vma=False))
        rows, total = fn(state, batches[0][1])
        out.update(overflow=int(total), rows=jax.device_get(rows))
    state = jax.device_get(state)
    out["tables"] = {f"{c}/{g}": np.asarray(t) for c, groups in state.emb_params.items() for g, t in groups.items()}
    out["sparse"] = {f"{c}/{g}/{k}": np.asarray(v) for c, groups in state.emb_opt.items()
                     for g, s in groups.items() for k, v in s.items()}
    out["dense"] = [np.asarray(x) for x in jax.tree_util.tree_leaves(state.dense_params)]
    return out


def _local_engine(spec):
    model = build_model(spec["model"], _schema(spec, False), **spec["model_kw"])
    return Engine(model, dense_lr=spec["dense_lr"], emb_lr=spec["emb_lr"], sparse_optimizer=spec["sparse_opt"])


def _local_run(spec, start, batches) -> dict:
    """The port's single-device engine's results on the case."""
    eng = _local_engine(spec)
    state = _port_state(eng, start)
    tensors = [tuple(torch.from_numpy(a) for a in b) for b in batches]
    out = {}
    kind = spec["kind"]
    if kind in ("steps", "scan"):
        losses = []
        for b in tensors:
            state, m = eng.train_step(state, *b)
            losses.append(m["loss"].item())
        out["losses"] = losses
    elif kind == "accum":
        state, m = eng.train_step_accum(state, *tensors[0])
        out["losses"] = [m["loss"].item()]
    elif kind == "eval":
        auc = auc_init(device="cpu")
        for b in tensors:
            eng.eval_step(state, auc, *b)
        out["auc"] = {k: float(v) for k, v in auc_compute(auc).items() if k in ("auc", "logloss")}
    elif kind == "overflow":
        _, ids, _ = tensors[0]
        out["rows"] = eng.tables.gather(state.emb_params, eng._group_ids(ids), torch.float32)
    out["tables"] = {f"{c}/{g}": t.numpy() for c, groups in state.emb_params.items() for g, t in groups.items()}
    out["sparse"] = {f"{c}/{g}/{k}": v.numpy() for c, groups in state.emb_opt.items()
                     for g, s in groups.items() for k, v in s.items()}
    out["dense"] = [t.numpy() for t in leaves(state.dense_params)]
    out["groups"] = {f"{c}/{g.name}": g.total_rows for c, coll in eng.collections.items() for g in coll.groups}
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case's start state and batches; the port's gloo worlds of 2 and
    4 ranks (started first, each in its own processes); JAX's sharded runs
    and the port's local runs in this process meanwhile. A world that fails
    or hangs leaves its error in ``errors``."""
    work = tmp_path_factory.mktemp("sharded")
    inputs = {name: dict(spec=spec, state=_start_state(spec), batches=_batches(spec)) for name, spec in CASES.items()}
    worlds = {}
    for world, names in WORLDS.items():
        path, out_dir = work / f"inputs{world}.pkl", work / f"world{world}"
        out_dir.mkdir()
        with open(path, "wb") as f:
            pickle.dump({n: inputs[n] for n in names}, f)
        port = _free_port()
        logs = [open(out_dir / f"rank{r}.log", "w") for r in range(world)]
        procs = [subprocess.Popen([sys.executable, WORKER, str(path), str(r), str(world), str(port), str(out_dir)],
                                  cwd=ROOT, env={**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1"},
                                  stdout=logs[r], stderr=subprocess.STDOUT)
                 for r in range(world)]
        worlds[world] = (out_dir, procs, logs)
    t0 = time.monotonic()
    jax_out = {(n, w): _jax_run(CASES[n], inputs[n]["state"], inputs[n]["batches"], w)
               for w, names in WORLDS.items() for n in names}
    local = {n: _local_run(CASES[n], inputs[n]["state"], inputs[n]["batches"]) for n in CASES}
    port, errors = {}, {}
    for world, (out_dir, procs, logs) in worlds.items():
        for p in procs:
            try:
                p.wait(timeout=max(1.0, WORLD_TIMEOUT_S - (time.monotonic() - t0)))
            except subprocess.TimeoutExpired:
                pass
        hung = [p for p in procs if p.poll() is None]
        for p in hung:
            p.kill()
            p.wait()
        for f in logs:
            f.close()
        codes = [p.returncode for p in procs]
        if hung or any(codes):
            tail = "".join((out_dir / f"rank{r}.log").read_text()[-2000:] for r in range(world))
            errors[world] = f"world {world}: exit codes {codes}{' (hung, killed)' if hung else ''}\n{tail}"
            continue
        ranks = []
        for r in range(world):
            with open(out_dir / f"rank{r}.pkl", "rb") as f:
                ranks.append(pickle.load(f))  # written by this test's workers
        port[world] = ranks
    return dict(jax=jax_out, local=local, port=port, errors=errors)


def _ranks(runs, name, world) -> list:
    """Each rank's results of the case, after checking the world ran it."""
    assert world not in runs["errors"], runs["errors"][world]
    out = [r[name] for r in runs["port"][world]]
    for rank, o in enumerate(out):
        assert "error" not in o, f"rank {rank}: {o['error']}"
    return out


def _assembled(ranks, key: str) -> np.ndarray:
    """A table or sparse state from its rank blocks, in rank order."""
    return np.concatenate([r["state"][key] for r in ranks])


def _check_state(ranks, want: dict, groups: dict, what: str) -> None:
    """The port's final state against ``want`` (``_jax_run``'s or
    ``_local_run``'s) on the unpadded prefix."""
    for key, rows in groups.items():
        c, g = key.split("/")
        np.testing.assert_allclose(_assembled(ranks, key)[:rows], want["tables"][f"{c}/{g}"][:rows], **STATE_TOL,
                                   err_msg=f"{what}: table {key}")
        for k in [k for k in want["sparse"] if k.startswith(key + "/")]:
            np.testing.assert_allclose(_assembled(ranks, k)[:rows], want["sparse"][k][:rows], **STATE_TOL,
                                       err_msg=f"{what}: {k}")
    for rank in ranks:
        for got, w in zip(rank["state"]["dense"], want["dense"]):
            np.testing.assert_allclose(got, w, **STATE_TOL, err_msg=f"{what}: dense leaf")


STEP_PAIRS = [(n, w) for w, names in WORLDS.items() for n in names if CASES[n]["kind"] == "steps"]


@pytest.mark.parametrize("name,world", STEP_PAIRS, ids=[f"{n}-{w}" for n, w in STEP_PAIRS])
def test_sharded_step_matches_jax_and_local(runs, name, world):
    """The sharded step (Adagrad, lazy Adam, dense Adam; per-slot dims: two
    groups and an unfused wide table) against JAX's shard_map step at the
    same world size and the port's local step: every loss, every rank's
    overflow 0 as JAX's, and the final tables, sparse states and dense
    state."""
    ranks = _ranks(runs, name, world)
    jax_out, local = runs["jax"][(name, world)], runs["local"][name]
    for r in ranks:
        assert r["overflows"] == jax_out["overflows"] == [0] * len(jax_out["overflows"])
        np.testing.assert_allclose(r["losses"], jax_out["losses"], **LOSS_TOL)
        np.testing.assert_allclose(r["losses"], local["losses"], **LOSS_TOL)
    _check_state(ranks, jax_out, local["groups"], "against JAX")
    _check_state(ranks, local, local["groups"], "against the local engine")


def test_sharded_eval_matches_jax_and_local(runs):
    """Sharded eval (DCN): every rank's AUC state is the whole batch's, its
    AUC and logloss JAX's and the local engine's."""
    ranks = _ranks(runs, "eval", 2)
    want = runs["jax"][("eval", 2)]["auc"]
    for r in ranks:
        got = auc_compute(AUCState(*(torch.from_numpy(a) for a in r["auc"])))
        assert int(got["count"]) == 128
        for what, w in (("JAX", want), ("local", runs["local"]["eval"]["auc"])):
            np.testing.assert_allclose(float(got["auc"]), w["auc"], atol=1e-6, err_msg=what)
            np.testing.assert_allclose(float(got["logloss"]), w["logloss"], atol=1e-5, err_msg=what)


@pytest.mark.parametrize("world", [w for w, names in WORLDS.items() if "overflow" in names])
def test_overflow_counts_equal_jax_and_rows_are_zero(runs, world):
    """At capacity factor 0.05 the ranks' overflow counts sum to JAX's
    total exactly; JAX's rows equal the port's bit for bit; an overflowed
    lookup is a zero row, and every other row is the local gather's."""
    ranks = _ranks(runs, "overflow", world)
    jax_out, local = runs["jax"][("overflow", world)], runs["local"]["overflow"]
    total = sum(r["overflow"] for r in ranks)
    assert total == jax_out["overflow"] > 0
    for c, groups in local["rows"].items():
        for g, want in groups.items():
            got = np.concatenate([r["rows"][c][g] for r in ranks])
            np.testing.assert_array_equal(got, np.asarray(jax_out["rows"][c][g]))
            want = want.numpy()
            zero = ~got.reshape(-1, got.shape[-1]).any(axis=1)
            assert not (~want.reshape(-1, want.shape[-1]).any(axis=1)).any()  # no local row is all zero
            assert int(zero.sum()) == total
            np.testing.assert_array_equal(got.reshape(-1, got.shape[-1])[~zero],
                                          want.reshape(-1, want.shape[-1])[~zero])


def test_parallel_scan_matches_stepwise(runs):
    """``build_parallel_scan`` of 3 steps: its losses and final state the
    stepwise parallel steps' bit for bit, its losses JAX's scan's and the
    local engine's, its state JAX's."""
    ranks = _ranks(runs, "scan", 2)
    jax_out, local = runs["jax"][("scan", 2)], runs["local"]["scan"]
    for r in ranks:
        assert r["losses"] == r["step_losses"] and r["overflow"] == jax_out["overflow"] == 0
        for key, a in r["stepwise"].items():
            b = r["state"][key]
            assert all(np.array_equal(x, y) for x, y in zip(a, b)) if key == "dense" else np.array_equal(a, b), key
        np.testing.assert_allclose(r["losses"], jax_out["losses"], **LOSS_TOL)
        np.testing.assert_allclose(r["losses"], local["losses"], **LOSS_TOL)
    _check_state(ranks, jax_out, local["groups"], "against JAX")


def test_parallel_accum_matches_jax(runs):
    """``build_parallel_accum`` with A = 2 micro-batches of 32, each split
    over 2 ranks: the loss, overflow and final state JAX's and the local
    accumulated step's."""
    ranks = _ranks(runs, "accum", 2)
    jax_out, local = runs["jax"][("accum", 2)], runs["local"]["accum"]
    for r in ranks:
        assert r["overflows"] == jax_out["overflows"] == [0]
        np.testing.assert_allclose(r["losses"], jax_out["losses"], **LOSS_TOL)
        np.testing.assert_allclose(r["losses"], local["losses"], **LOSS_TOL)
    _check_state(ranks, jax_out, local["groups"], "against JAX")
    _check_state(ranks, local, local["groups"], "against the local engine")


# ------------------------------------------------------- in this process
def _fake_mesh(d: int) -> Mesh:
    return Mesh(group=None, size=d, rank=0, device=torch.device("cpu"))


@pytest.mark.parametrize("d", [1, 2, 4, 8])
def test_geometry_equals_jax(d):
    """``padded_rows``, ``rows_per_shard`` and the bucket capacity are the
    JAX package's, so the shard bounds and the overflow counts are too."""
    spec = CASES["per_slot_dims"]
    jcolls = JEngine(jbuild_model(spec["model"], _schema(spec, True), **spec["model_kw"])).collections
    colls = _local_engine(spec).collections
    js = JShardedTables(jcolls, None, n_shards=d)
    ps = ShardedTables(colls, None, _fake_mesh(d))
    for name, coll in colls.items():
        for g, jg in zip(coll.groups, jcolls[name].groups):
            assert ps.padded_rows(name, g) == js.padded_rows(name, jg)
            assert ps.rows_per_shard(name, g) == js.rows_per_shard(name, jg)
    for n in (1, 7, 64 * 26, 425_984, 1_000_003):
        for factor in (0.05, 1.25, 4.0):
            js.capacity_factor = ps.capacity_factor = factor
            assert ps._capacity(n) == js._capacity(n), (n, factor)


def test_state_specs_split_the_tables_by_rows():
    """Tables and their sparse states split by rows; the step, the dense
    parameters and their optimizer state replicated."""
    eng = _local_engine(CASES["adam"])
    specs = state_specs(eng.init(seed=0, device="cpu"))
    assert specs.step == REPLICATED and ROWS == DATA_AXIS
    assert set(leaves(specs.emb_params)) == {ROWS} and set(leaves(specs.emb_opt)) == {ROWS}
    assert set(leaves(specs.dense_params)) == {REPLICATED} and set(leaves(specs.dense_opt)) == {REPLICATED}


def test_dense_adam_drops_sentinels():
    """Dense Adam on the owner's stream: ids at or past the table's rows
    (the sentinel R) and their grads are dropped, as JAX's scatter drops
    them; the rest of the update is the update of the stream without them,
    bit for bit."""
    rng = np.random.default_rng(0)
    rows, dim = 64, 5
    ids = np.sort(rng.integers(0, rows, 40)).astype(np.int32)
    grads = rng.normal(size=(40, dim)).astype(np.float32)
    opt = dense_adam()

    def run(ids_np, grads_np):
        table = torch.from_numpy(rng_table.copy())
        state = opt.init(rows, dim, "cpu")
        apply_sorted_updates(opt, table, state, torch.from_numpy(ids_np), torch.from_numpy(grads_np),
                             torch.tensor(3, dtype=torch.int32), torch.tensor(1e-2))
        return table, state

    rng_table = rng.normal(size=(rows, dim)).astype(np.float32)
    tail = np.full(12, rows, np.int32)
    got_t, got_s = run(np.concatenate([ids, tail]), np.concatenate([grads, rng.normal(size=(12, dim))]).astype(np.float32))
    want_t, want_s = run(ids, grads)
    assert torch.equal(got_t, want_t) and all(torch.equal(got_s[k], want_s[k]) for k in ("m", "v"))


@pytest.fixture(scope="module")
def world_of_one():
    """A gloo world of one rank in this process, for the cases that need no
    second rank."""
    dist.init_process_group("gloo", store=dist.HashStore(), world_size=1, rank=0)
    try:
        yield make_mesh(1)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("config", ["adagrad_fused", "adam_unfused", "adam_dense"])
def test_world_of_one_equals_local_bit_for_bit(world_of_one, config):
    """A world of one: three sharded steps (the slice-2 layout, a fused
    wide column and Adagrad; slice 3's, unfused with lazy Adam on both
    tables; dense Adam) equal the local engine's bit for bit, losses and
    every tensor of the state, and eval's AUC state too."""
    sch = criteo_schema(vocab_size=50, embed_dim=8)
    kw = dict(hidden=(16,), cin_sizes=(16, 16))
    opt = {"adagrad_fused": "adagrad", "adam_unfused": "adam", "adam_dense": "adam_dense"}[config]
    fuse = config != "adam_unfused"
    sharded = build_parallel_engine(build_model("xdeepfm", sch, **kw), world_of_one, sparse_optimizer=opt,
                                    fuse_wide=fuse)
    local = Engine(build_model("xdeepfm", sch, **kw), sparse_optimizer=opt, fuse_wide=fuse)
    ls = local.init(seed=0, device="cpu")
    ss = shard_state(sharded.init(seed=0, device="cpu"), world_of_one)
    train, evaluate = build_parallel_steps(sharded, world_of_one)
    for seed in range(3):
        b = next(iter(SyntheticSource(jcriteo_schema(vocab_size=50, embed_dim=8), batch_size=32, seed=seed)))
        batch = tuple(torch.from_numpy(a) for a in (b.dense, b.ids, b.labels))
        ss, ms = train(ss, *batch)
        ls, ml = local.train_step(ls, *batch)
        assert torch.equal(ms["loss"], ml["loss"]) and int(ms["overflow"]) == 0 and ml["overflow"] == 0
    for a, b in zip(leaves(ss._asdict()), leaves(ls._asdict())):
        assert torch.equal(a, b)
    auc_s, auc_l = auc_init(device="cpu"), auc_init(device="cpu")
    evaluate(ss, auc_s, *batch)
    local.eval_step(ls, auc_l, *batch)
    assert all(torch.equal(a, b) for a, b in zip(auc_s, auc_l))


def test_engine_takes_the_mesh_of_its_table_strategy(world_of_one):
    """An engine handed a sharded strategy instance (not the factory) has
    its mesh, so its steps reduce over the ranks and the parallel steps take
    it; an engine of local tables has none."""
    sch = criteo_schema(vocab_size=50, embed_dim=4)
    built = build_parallel_engine(build_model("fm", sch), world_of_one)
    eng = Engine(build_model("fm", sch), table_strategy=built.tables)
    assert built.mesh is world_of_one and eng.mesh is world_of_one and eng.tables is built.tables
    assert Engine(build_model("fm", sch)).mesh is None
    state = shard_state(built.init(seed=0, device="cpu"), world_of_one)
    b = next(iter(SyntheticSource(jcriteo_schema(vocab_size=50, embed_dim=4), batch_size=8, seed=0)))
    batch = tuple(torch.from_numpy(a) for a in (b.dense, b.ids, b.labels))
    train, _ = build_parallel_steps(eng, world_of_one)
    (s1, m1), (s2, m2) = train(copy.deepcopy(state), *batch), built.train_step(state, *batch)
    assert torch.equal(m1["loss"], m2["loss"]) and isinstance(m1["overflow"], torch.Tensor)
    assert all(torch.equal(x, y) for x, y in zip(leaves(s1._asdict()), leaves(s2._asdict())))


def test_mesh_and_steps_refuse_what_they_cannot_run(world_of_one):
    """``make_mesh`` refuses a world of another size; a state on another
    device, an engine of another mesh and a batch the ranks cannot split
    are refused, not moved or run."""
    with pytest.raises(ValueError, match="not 2"):
        make_mesh(2)
    assert world_of_one.device == torch.device("cpu") and world_of_one.size == 1
    other = Mesh(group=None, size=1, rank=0, device=torch.device("meta"))
    eng = _local_engine(CASES["adagrad"])
    with pytest.raises(ValueError, match="lies on cpu"):
        shard_state(eng.init(seed=0, device="cpu"), other)
    sch = criteo_schema(vocab_size=50, embed_dim=4)
    sharded = build_parallel_engine(build_model("fm", sch), world_of_one)
    with pytest.raises(ValueError, match="another mesh"):
        build_parallel_steps(sharded, other)
    two = _fake_mesh(2)  # the batch is refused before any collective
    sharded2 = build_parallel_engine(build_model("fm", sch), two)
    state = shard_state(sharded2.init(seed=0, device="cpu"), two)
    b = next(iter(SyntheticSource(jcriteo_schema(vocab_size=50, embed_dim=4), batch_size=3, seed=0)))
    train, _ = build_parallel_steps(sharded2, two)
    with pytest.raises(ValueError, match="does not split"):
        train(state, *(torch.from_numpy(a) for a in (b.dense, b.ids, b.labels)))
