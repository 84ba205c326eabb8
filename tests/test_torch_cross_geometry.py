"""``CheckpointManager.restore_cross_geometry`` of the port across table
geometries, held against the JAX package's, and export from a sharded
run's checkpoint, on the CPU (``tests/test_checkpoint.py:73-137``'s case:
FM, vocab 700, dim 8).

A local state trained three steps in JAX is carried into the port and
checkpointed; gloo worlds of 4 and then 2 ranks
(``tests/torch_multihost_worker.py``, no JAX) restore it across geometries
(local -> 4 -> 2: ``padded_rows`` depends on the world size) and save what
they restored; this process restores world 2's checkpoint locally (2 ->
local) and exports it. Logits: the local model's within rtol = atol =
1e-5, as JAX's test holds its own (the same f32 math, the sharded rows
gathered across ranks). Each world's checkpoint holds the global padded
state, whose tables and sparse states equal JAX's ``restore_cross_geometry``
output at the same shard count bit for bit: both copy the saved rows and
pad with zeros.
"""

import dataclasses
import json
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recmodels_tpu.data import SyntheticSource as JSyntheticSource
from recmodels_tpu.data import criteo_schema as jcriteo_schema
from recmodels_tpu.models import build_model as jbuild_model
from recmodels_tpu.parallel import build_parallel_engine as jbuild_parallel_engine
from recmodels_tpu.parallel import make_mesh as jmake_mesh
from recmodels_tpu.parallel import shard_state as jshard_state
from recmodels_tpu.serve import load_predictor as jload_predictor
from recmodels_tpu.train.checkpoint import CheckpointManager as JCheckpointManager
from recmodels_tpu.train.engine import Engine as JEngine
from recmodels_tpu_torch.data import criteo_schema
from recmodels_tpu_torch.models import build_model
from recmodels_tpu_torch.serve import export_from_checkpoint
from recmodels_tpu_torch.train.checkpoint import CheckpointManager
from recmodels_tpu_torch.train.engine import Engine
from recmodels_tpu_torch.utils.config import TrainConfig
from recmodels_tpu_torch.utils.tree import leaves

import torch_multihost_worker as worker
from torch_jax_bridge import port_state_from_jax

VOCAB, DIM = 700, 8
LOGIT_TOL = dict(rtol=1e-5, atol=1e-5)  # tests/test_checkpoint.py's
CFG = TrainConfig(model="fm", vocab_size=VOCAB, embed_dim=DIM, dense_lr=1e-2, emb_lr=5e-2, capacity_factor=4.0)


def _port_engine():
    return Engine(build_model("fm", criteo_schema(vocab_size=VOCAB, embed_dim=DIM)), dense_lr=1e-2, emb_lr=5e-2)


def _jax_restored(mgr, shards: int, key: int) -> dict:
    """JAX's ``restore_cross_geometry`` of ``mgr``'s latest checkpoint into
    an FM engine sharded over ``shards`` fake devices, as numpy."""
    mesh = jmake_mesh(shards)
    eng = jbuild_parallel_engine(jbuild_model("fm", jcriteo_schema(vocab_size=VOCAB, embed_dim=DIM)), mesh,
                                 dense_lr=1e-2, emb_lr=5e-2, capacity_factor=4.0)
    state, _ = mgr.restore_cross_geometry(jshard_state(eng.init(jax.random.key(key)), mesh))
    return jax.device_get(state)


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    """JAX's local state and logits; the port's local checkpoint of it; the
    worlds of 4 and 2; JAX's restores at 4 and 2 shards (meanwhile)."""
    work = tmp_path_factory.mktemp("geometry")
    sch = jcriteo_schema(vocab_size=VOCAB, embed_dim=DIM)
    jeng = JEngine(jbuild_model("fm", sch), dense_lr=1e-2, emb_lr=5e-2)
    jstate = jeng.init(jax.random.key(0))
    step = jeng.jit_train_step()
    src = iter(JSyntheticSource(sch, batch_size=64, seed=1))
    for _ in range(3):
        b = next(src)
        jstate, _ = step(jstate, jnp.asarray(b.dense), jnp.asarray(b.ids), jnp.asarray(b.labels))
    b = next(src)
    want = np.asarray(jeng.logits(jstate, jnp.asarray(b.dense), jnp.asarray(b.ids)))
    with open(work / "batch.pkl", "wb") as f:
        pickle.dump((b.dense, b.ids), f)

    local = port_state_from_jax(jeng, jstate, _port_engine())
    mgr = CheckpointManager(str(work / "local"))
    mgr.save(int(local.step), local, {"cursor": 7})
    mgr.wait()
    world4 = worker.start("geometry", 4, work / "world4", work / "local", work / "w4", work / "batch.pkl")

    jmgr = JCheckpointManager(str(work / "jax_local"), save_interval_steps=1)
    jmgr.save(int(jstate.step), jax.device_get(jstate), {"cursor": 7})
    jmgr.wait()
    jax4 = _jax_restored(jmgr, 4, 1)
    jmgr4 = JCheckpointManager(str(work / "jax_4"), save_interval_steps=1)
    jmgr4.save(int(jax4.step), jax4, {})
    jmgr4.wait()
    jax2 = _jax_restored(jmgr4, 2, 2)
    jmgr.close()
    jmgr4.close()

    ranks4 = worker.finish(world4)
    ranks2 = worker.finish(worker.start("geometry", 2, work / "world2", work / "w4", work / "w2", work / "batch.pkl"))
    return dict(work=work, want=want, batch=(b.dense, b.ids), local=local, ranks={4: ranks4, 2: ranks2},
                jax={4: jax4, 2: jax2})


def _saved(path) -> dict:
    mgr = CheckpointManager(str(path))
    return torch.load(path / str(mgr.latest_step()) / "state.pt", weights_only=True)


@pytest.mark.parametrize("world", [4, 2])
def test_restore_across_world_sizes_keeps_the_logits(chain, world):
    """local -> 4 and 4 -> 2: every rank restores into its own block (the
    target's own tensors), the step and the cursor pass through, and the
    sharded logits (each rank its block of the batch) are the local
    model's."""
    ranks = chain["ranks"][world]
    for r in ranks:
        assert r["restored_is_target"] and r["step"] == 3 and r["data"] == {"cursor": 7}
    got = np.concatenate([r["logits"] for r in ranks])
    np.testing.assert_allclose(got, chain["want"], **LOGIT_TOL)


@pytest.mark.parametrize("world", [4, 2])
def test_restored_global_state_equals_jax_bit_for_bit(chain, world):
    """The checkpoint each world saved (the gathered global padded state)
    holds JAX's ``restore_cross_geometry`` output at the same shard count:
    the padded tables and sparse states bit for bit, the dense state and
    the step unchanged. ``gather_state`` gave rank 0 the same state and the
    other ranks None."""
    saved, jst = _saved(chain["work"] / f"w{world}"), chain["jax"][world]
    for c, groups in jst.emb_params.items():
        for g, t in groups.items():
            got = saved["emb_params"][c][g].numpy()
            assert got.shape[0] % (world * 1024) == 0 and got.shape == np.shape(t)
            np.testing.assert_array_equal(got, np.asarray(t))
            for k, v in jst.emb_opt[c][g].items():
                np.testing.assert_array_equal(saved["emb_opt"][c][g][k].numpy(), np.asarray(v))
    local = chain["local"]
    assert int(saved["step"]) == int(jst.step) == 3
    for a, b in zip(leaves(saved["dense_params"]), leaves(local.dense_params)):
        assert torch.equal(a, b)
    ranks = chain["ranks"][world]
    assert all(r["gathered"] is None for r in ranks[1:])
    assert all(np.array_equal(a, b.numpy()) for a, b in zip(ranks[0]["gathered"], leaves(saved)))


def test_restore_from_world_two_to_local(chain):
    """2 -> local in this process: the local state is the one the chain
    started from, bit for bit (the canonical rows travelled unchanged), and
    so are its logits."""
    eng = _port_engine()
    state, data = CheckpointManager(str(chain["work"] / "w2")).restore_cross_geometry(eng.init(seed=3, device="cpu"))
    assert data == {"cursor": 7}
    for a, b in zip(leaves(state._asdict()), leaves(chain["local"]._asdict())):
        assert torch.equal(a, b)
    dense, ids = (torch.from_numpy(a) for a in chain["batch"])
    np.testing.assert_allclose(eng.logits(state, dense, ids).detach().numpy(), chain["want"], **LOGIT_TOL)


@pytest.mark.parametrize("world", [2, 4])
def test_export_from_a_sharded_runs_checkpoint(chain, tmp_path, world):
    """``export_from_checkpoint`` of the checkpoint a world of 2 (or 4)
    wrote runs here, in one process with no group; JAX's
    ``load_predictor`` loads the artifact and scores the local model's
    logits; its tables are the checkpoint's global tables cut to
    ``alloc_rows`` (at world 4, 20,480 padded rows to 18,432).
    ``cli.predict --ckpt-dir`` scores from the same checkpoint."""
    import torch.distributed as dist

    ckpt = chain["work"] / f"w{world}"
    (ckpt / "config.json").write_text(dataclasses.replace(CFG, n_devices=world).to_json())
    assert not dist.is_initialized()
    export_from_checkpoint(str(ckpt), str(tmp_path), device="cpu")
    pred = jload_predictor(str(tmp_path))
    dense, ids = chain["batch"]
    np.testing.assert_allclose(np.asarray(pred.predict_logits(dense, ids)), chain["want"], **LOGIT_TOL)
    saved = _saved(ckpt)
    eng = _port_engine()
    with np.load(tmp_path / "params.npz") as art:
        for name, coll in eng.collections.items():
            for g in coll.groups:
                np.testing.assert_array_equal(art[f"emb/{name}/{g.name}"],
                                              saved["emb_params"][name][g.name][: g.alloc_rows].numpy())
    assert json.loads((tmp_path / "model.json").read_text())["n_devices"] == world
    assert saved["emb_params"]["emb"]["d9"].shape[0] == {2: 18_432, 4: 20_480}[world]
    from recmodels_tpu_torch.cli import predict

    out = tmp_path / "preds.txt"  # cli.predict on the same checkpoint, in this process too
    assert predict.main(["--cpu", "--ckpt-dir", str(ckpt), "--data", "synthetic", "--batch-size", "64",
                         "--max-batches", "1", "--out", str(out)]) == 0
    assert len(out.read_text().split()) == 64
