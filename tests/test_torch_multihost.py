"""Several processes (``recmodels_tpu_torch/parallel/multihost.py``) and the
Trainer's multi-device branch on the CPU: gloo worlds of two ranks
(``tests/torch_multihost_worker.py``, which imports no JAX) held against
the JAX package in this process, as ``tests/test_multihost.py`` holds
JAX's two processes, at its sizes (FM, vocab 400, dim 8, 32 examples a
process, capacity 4.0).

- Two-process sharded steps: each rank feeds its own shard of the stream
  to the per-rank step; the losses are the JAX oracle's (one process, a
  mesh of 2 fake devices, the two shards' batches concatenated) within
  ``tests/test_torch_sharded.py``'s loss tolerance (rtol 1e-5: the same
  math in another summation order).
- The Trainer's product path: the oracle's tolerances
  (``tests/test_multihost.py:223-237``): the dense parameters' |.| sum
  within 2e-3, the table's relative 1e-4, AUC within 1e-3.
- The kill drill: a rank SIGKILLed mid-run, both restarted: byte for byte
  the control run, rank by rank.

Then the single-process cases: the failure policy of ``initialize``, a
launcher's environment, and the Trainer's errors without a group.
"""

import io
import json
import os
import socket
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from recmodels_tpu.data import SyntheticSource as JSyntheticSource
from recmodels_tpu.data import criteo_schema as jcriteo_schema
from recmodels_tpu.models import build_model as jbuild_model
from recmodels_tpu.parallel import (
    build_parallel_engine as jbuild_parallel_engine,
    build_parallel_scan as jbuild_parallel_scan,
    build_parallel_steps as jbuild_parallel_steps,
    make_mesh as jmake_mesh,
    shard_state as jshard_state,
)
from recmodels_tpu.train import metrics as jmetrics
from recmodels_tpu_torch.data import criteo_schema
from recmodels_tpu_torch.models import build_model
from recmodels_tpu_torch.parallel import Mesh, build_parallel_engine, multihost
from recmodels_tpu_torch.train.loop import Trainer
from recmodels_tpu_torch.utils.config import TrainConfig
from recmodels_tpu_torch.utils.logging import MetricsLogger
from recmodels_tpu_torch.utils.tree import leaves

import torch_multihost_worker as worker
from torch_jax_bridge import port_names, port_state_from_jax

LOSS_TOL = dict(rtol=1e-5)  # tests/test_torch_sharded.py's
VOCAB, DIM, BATCH = 400, 8, 32


def _jax_engine(mesh, **kw):
    sch = jcriteo_schema(vocab_size=VOCAB, embed_dim=DIM)
    return jbuild_parallel_engine(jbuild_model("fm", sch), mesh, emb_lr=5e-2, capacity_factor=4.0, **kw)


def _start_file(path, jeng, jstate0, **kw) -> str:
    """The port's global padded state holding JAX's ``jstate0`` (of the
    sharded ``jeng``), saved for the ranks."""
    sch = criteo_schema(vocab_size=VOCAB, embed_dim=DIM)
    mesh2 = Mesh(group=None, size=2, rank=0, device=torch.device("cpu"))  # geometry only: no collective runs
    eng = build_parallel_engine(build_model("fm", sch), mesh2, emb_lr=5e-2, capacity_factor=4.0, **kw)
    torch.save(port_state_from_jax(jeng, jstate0, eng)._asdict(), path)
    return str(path)


def _shard_batches(n: int, seed: int):
    """n global batches: the two shards' batches of 32, concatenated in rank order."""
    sch = jcriteo_schema(vocab_size=VOCAB, embed_dim=DIM)
    its = [iter(JSyntheticSource(sch, BATCH, seed=seed, shard_index=i, shard_count=2)) for i in (0, 1)]
    out = []
    for _ in range(n):
        b0, b1 = next(its[0]), next(its[1])
        out.append(tuple(np.concatenate([x0, x1]) for x0, x1 in
                         ((b0.dense, b1.dense), (b0.ids, b1.ids), (b0.labels, b1.labels))))
    return out


def test_two_process_sharded_steps_match_jax(tmp_path):
    """Two ranks started by ``multihost.initialize(coord, 2, pid,
    device="cpu")``, three per-rank steps from JAX's start state: both
    ranks report every loss of JAX's one-process oracle."""
    mesh = jmake_mesh(2)
    jeng = _jax_engine(mesh)
    jstate0 = jeng.init(jax.random.key(0))
    world = worker.start("steps", 2, tmp_path / "world", _start_file(tmp_path / "start.pt", jeng, jstate0))
    state = jshard_state(jstate0, mesh)
    train, _ = jbuild_parallel_steps(jeng, mesh, donate=False)
    want = []
    for b in _shard_batches(3, seed=0):
        state, m = train(state, *(jnp.asarray(x) for x in b))
        want.append(float(m["loss"]))
    ranks = worker.finish(world)
    assert ranks[0]["losses"] == ranks[1]["losses"]
    np.testing.assert_allclose(ranks[0]["losses"], want, **LOSS_TOL)


@pytest.fixture(scope="module")
def trainer_world(tmp_path_factory):
    """The two-rank Trainer world (product path, restore drill, per-rank
    cursors) started from JAX's start state, and the JAX oracle: the same
    global batches, three scans of 2 steps on a mesh of 2 fake devices,
    then eval of the two held-out shards' 2 batches."""
    work = tmp_path_factory.mktemp("trainer")
    mesh = jmake_mesh(2)
    jeng = _jax_engine(mesh, dense_lr=1e-2)
    jstate0 = jeng.init(jax.random.key(0))
    ckpt, tb = work / "ckpt", work / "tb"
    world = worker.start("trainer", 2, work / "world", _start_file(work / "start.pt", jeng, jstate0, dense_lr=1e-2),
                         ckpt, tb)
    state = jshard_state(jstate0, mesh)
    scan = jbuild_parallel_scan(jeng, mesh, donate=False)
    batches = _shard_batches(6, seed=0)
    for k in range(3):
        xs = batches[2 * k:2 * k + 2]
        state, _ = scan(state, *(jnp.asarray(np.stack([s[j] for s in xs])) for j in range(3)))
    _, eval_step = jbuild_parallel_steps(jeng, mesh, donate=False)
    auc = jmetrics.auc_init()
    for b in _shard_batches(2, seed=7_777_777):
        auc = eval_step(state, auc, *(jnp.asarray(x) for x in b))
    oracle = dict(d=float(sum(jnp.sum(jnp.abs(x)) for x in jax.tree_util.tree_leaves(state.dense_params))),
                  e=float(jnp.sum(jnp.abs(state.emb_params["emb"]["d9"]))),
                  auc=float(jmetrics.auc_compute(auc)["auc"]))
    ranks = worker.finish(world)
    logs = [(work / "world" / f"rank{r}.log").read_text() for r in range(2)]
    return dict(ranks=ranks, logs=logs, oracle=oracle, ckpt=ckpt, tb=tb)


def _named(arrays, pattern):
    sch = criteo_schema(vocab_size=VOCAB, embed_dim=DIM)
    mesh2 = Mesh(group=None, size=2, rank=0, device=torch.device("cpu"))
    state = build_parallel_engine(build_model("fm", sch), mesh2).init(seed=0, device="cpu")
    return [a for n, a in zip(port_names(state), arrays) if pattern in n]


def test_two_process_trainer_matches_jax_oracle(trainer_world):
    """``Trainer.run`` with ``n_devices`` from the group (2): every rank its
    own data shard, scans of 2 steps, eval every 3, checkpoints every 3.
    Both ranks report the same dense state, logged losses and AUC; with
    the table's two blocks, the state is the JAX oracle's within its
    tolerances, and so is the AUC."""
    r0, r1 = trainer_world["ranks"]
    assert r0["final"] == r1["final"]
    dense0, dense1 = _named(r0["state"], "dense_params"), _named(r1["state"], "dense_params")
    assert all(np.array_equal(a, b) for a, b in zip(dense0, dense1))
    table = np.concatenate([_named(r["state"], "emb_params/emb/d9")[0] for r in (r0, r1)])
    got = dict(d=float(sum(np.abs(x).sum() for x in dense0)), e=float(np.abs(table).sum()))
    want = trainer_world["oracle"]
    assert abs(got["d"] - want["d"]) < 2e-3, (got, want)
    assert abs(got["e"] - want["e"]) / max(abs(want["e"]), 1.0) < 1e-4, (got, want)
    assert abs(r0["final"]["auc"] - want["auc"]) < 1e-3, (r0["final"], want)
    logged = [[{k: v for k, v in json.loads(line.split(" train ")[1]).items() if k != "examples_per_sec"}
               for line in log.splitlines() if " train {" in line] for log in trainer_world["logs"]]
    assert len(logged[0]) == 3 and logged[0] == logged[1]  # logs at steps 2, 4, 6, on every rank


def test_two_process_restore_drill_and_primary_only_writes(trainer_world):
    """A new Trainer on each rank restores the forced final checkpoint (one
    global file) into its block: bit for bit the live final state. Only
    rank 0 wrote the run's config and TensorBoard scalars; the checkpoint
    directory holds steps 2 (the first save, at any step) and 6 and
    nothing else of either rank."""
    for r in trainer_world["ranks"]:
        assert all(np.array_equal(a, b) for a, b in zip(r["restored"], r["state"]))
        assert r["data"] == {"step": 6} and r["steps"] == [2, 6]
    assert [r["config_writes"] for r in trainer_world["ranks"]] == [1, 0]
    assert sorted(os.listdir(trainer_world["tb"])) == ["events.rank0"]
    assert sorted(os.listdir(trainer_world["ckpt"])) == ["2", "6", "config.json", "cursors"]
    assert sorted(os.listdir(trainer_world["ckpt"] / "6")) == ["data.json", "state.pt"]


def test_cursors_that_differ_by_rank_resume_per_rank(trainer_world):
    """Cursors that differ by rank are recorded one a rank and each rank
    restores its own; equal ones are stored once. A world of another size
    (here one process) cannot resume per-rank cursors: it raises."""
    from recmodels_tpu_torch.train.checkpoint import CheckpointManager

    ranks = trainer_world["ranks"]
    for rank, r in enumerate(ranks):
        assert r["cursors"] == [{"rows_consumed": 10 + rank}, {"rows_consumed": 20}]
    cursors = trainer_world["ckpt"] / "cursors"
    assert json.loads((cursors / "1" / "data.json").read_text()) == {
        "per_rank_cursors": [{"rows_consumed": 10}, {"rows_consumed": 11}]}
    assert json.loads((cursors / "2" / "data.json").read_text()) == {"rows_consumed": 20}
    sch = criteo_schema(vocab_size=VOCAB, embed_dim=DIM)
    local = build_parallel_engine(build_model("fm", sch), Mesh(None, 1, 0, torch.device("cpu"))).init(
        seed=0, device="cpu")
    mgr = CheckpointManager(str(cursors))
    assert mgr.restore_cross_geometry(local, step=2)[1] == {"rows_consumed": 20}
    with pytest.raises(ValueError, match="one data cursor for each of 2 ranks; a world of 1 cannot resume"):
        mgr.restore_cross_geometry(local, step=1)


def test_two_process_kill_drill(tmp_path):
    """tests/test_multihost.py's drill: rank 1 SIGKILLs itself after 5
    steps (checkpoints at 2 and 4 written or in flight), rank 0 is killed
    once blocked, both restart on the same directory and resume to step
    8: each rank's final state byte for byte the unkilled control's."""
    control = worker.start("kill", 2, tmp_path / "control", tmp_path / "ctrl_ckpt", 0)
    faulted = worker.start("kill", 2, tmp_path / "faulted", tmp_path / "kill_ckpt", 5)
    faulted[0][1].wait(timeout=worker.WORLD_TIMEOUT_S)
    assert faulted[0][1].returncode == -9  # it SIGKILLed itself
    time.sleep(2.0)  # rank 0 waits in a collective on a rank that is gone
    worker.finish(faulted, expect_killed=True)
    assert not os.path.exists(tmp_path / "kill_ckpt" / "8")
    want = worker.finish(control)
    resumed = worker.finish(worker.start("kill", 2, tmp_path / "resumed", tmp_path / "kill_ckpt", 0))
    assert [r["step"] for r in want] == [r["step"] for r in resumed] == [8, 8]
    assert [r["hash"] for r in resumed] == [r["hash"] for r in want]
    assert "resumed from checkpoint at step" in (tmp_path / "resumed" / "rank1.log").read_text()


# ------------------------------------------------------- one process
def _quiet(**kw) -> dict:
    return dict(logger=MetricsLogger(stream=io.StringIO()), device="cpu", **kw)


def _cfg(**kw) -> TrainConfig:
    return TrainConfig(**{**dict(model="fm", vocab_size=VOCAB, embed_dim=DIM, batch_size=BATCH), **kw})


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_explicit_unreachable_topology_raises():
    """A topology the caller asked for that cannot form raises
    ``RuntimeError`` once the rendezvous times out (no coordinator
    listens), and leaves the process without a group."""
    address = f"127.0.0.1:{_free_port()}"
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="explicitly requested topology"):
        multihost.initialize(address, 2, 1, device="cpu", timeout_s=2)
    assert time.monotonic() - t0 < 60 and not dist.is_initialized()
    with pytest.raises(RuntimeError, match="explicitly requested topology"):
        multihost.initialize(process_id=0, device="cpu", timeout_s=2)  # the rest of the topology missing


def test_zero_config_without_a_launcher_stays_single(monkeypatch):
    for k in multihost.LAUNCHER_ENV:
        monkeypatch.delenv(k, raising=False)
    multihost.initialize(device="cpu")
    assert not dist.is_initialized()
    assert multihost.host_shard() == (0, 1) and multihost.is_primary()


def test_zero_config_reads_the_launchers_environment(monkeypatch):
    """torchrun's variables for a world of one: a gloo group of one forms,
    ``host_shard`` reads it, and a second call leaves it as it is."""
    for k, v in dict(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()), WORLD_SIZE="1", RANK="0").items():
        monkeypatch.setenv(k, v)
    multihost.initialize(device="cpu", timeout_s=30)
    try:
        assert dist.is_initialized() and dist.get_backend() == "gloo"
        group = dist.group.WORLD
        multihost.initialize(device="cpu")
        assert dist.group.WORLD is group and multihost.host_shard() == (0, 1) and multihost.is_primary()
    finally:
        dist.destroy_process_group()


def test_trainer_with_several_devices_needs_a_group():
    """``n_devices=2`` without a process group raises, saying how to start
    one; ``data="device_synth"`` on a mesh raises as JAX's does."""
    with pytest.raises(RuntimeError, match=r"torchrun --nproc_per_node 2 -m recmodels_tpu_torch.cli.train.*"
                                           r"multihost.initialize\(address, 2, rank\)"):
        Trainer(_cfg(n_devices=2), **_quiet())
    for kw in (dict(data="device_synth"), dict(val_data="device_synth")):
        with pytest.raises(NotImplementedError, match="use the host pipeline for meshes"):
            Trainer(_cfg(n_devices=2, **kw), **_quiet())
    t = Trainer(_cfg(), **_quiet())  # n_devices None and no group: one device
    assert t.n_devices == 1 and t.mesh is None and t.engine.mesh is None
    assert all(isinstance(x, torch.Tensor) for x in leaves(t.engine.init(seed=0, device="cpu")._asdict()))
