"""The port's checkpoints (``recmodels_tpu_torch/train/checkpoint.py``) on the
CPU, as ``tests/test_checkpoint.py`` holds the JAX package's: a resumed run
continues bit for bit, a restore copies into the given state's own tensors,
and the manager keeps orbax's save policy (interval, first save, force,
max_to_keep) and ignores what a killed write leaves."""

import json
import os

import pytest
import torch

from recmodels_tpu_torch.data import SyntheticSource, criteo_schema
from recmodels_tpu_torch.models import build_model
from recmodels_tpu_torch.train.checkpoint import CheckpointManager
from recmodels_tpu_torch.train.engine import Engine
from recmodels_tpu_torch.train.schedules import build_lr_schedule
from recmodels_tpu_torch.utils.tree import leaves

SCH = criteo_schema(vocab_size=700, embed_dim=8)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Each test on one intra-op thread: the test run shares the host's cores
    among its workers, and torch's thread pool in each of them (one thread a
    core) oversubscribes the cores many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _engine(model="fm", **kw):
    return Engine(build_model(model, SCH), dense_lr=1e-2, emb_lr=5e-2, **kw)


def _args(b):
    return torch.from_numpy(b.dense), torch.from_numpy(b.ids), torch.from_numpy(b.labels)


def _tensors(state):
    return [t for t in leaves(state._asdict()) if isinstance(t, torch.Tensor)]


@pytest.mark.parametrize("kind", ["fm-adagrad", "xdeepfm-lazy-adam-scheduled"])
def test_save_restore_resume_bitwise(tmp_path, kind):
    """Five steps, a checkpoint, three more; a new engine restores into a
    state drawn from another seed and runs the same three steps: every
    tensor equal bit for bit, the cursor and the step restored. The second
    case carries lazy Adam's moments, dense Adam's count, the schedule's
    count and adamw's decay."""
    if kind == "fm-adagrad":
        make = _engine
    else:
        def make():
            return _engine("xdeepfm", sparse_optimizer="adam", fuse_wide=False,
                           dense_lr_schedule=build_lr_schedule(1e-2, "cosine", warmup_steps=3, total_steps=12),
                           emb_lr_schedule=build_lr_schedule(5e-2, "cosine", warmup_steps=3, total_steps=12),
                           dense_weight_decay=1e-3)
    eng = make()
    state = eng.init(seed=0, device="cpu")
    src = SyntheticSource(SCH, batch_size=64, seed=0)
    it = iter(src)
    for _ in range(5):
        state, _ = eng.train_step(state, *_args(next(it)))
    mgr = CheckpointManager(str(tmp_path / "ckpt"), save_interval_steps=1)
    assert mgr.save(5, state, data_state=src.state())
    mgr.wait()
    for _ in range(3):
        state, _ = eng.train_step(state, *_args(next(it)))

    eng2 = make()
    target = eng2.init(seed=1, device="cpu")
    mgr2 = CheckpointManager(str(tmp_path / "ckpt"))
    assert mgr2.latest_step() == 5
    restored, data_state = mgr2.restore(target)
    assert restored is target and int(restored.step) == 5 and data_state == {"step": 5}
    src2 = SyntheticSource(SCH, batch_size=64, seed=0)
    src2.set_state(data_state)
    it2 = iter(src2)
    for _ in range(3):
        restored, _ = eng2.train_step(restored, *_args(next(it2)))
    assert all(torch.equal(a, b) for a, b in zip(_tensors(state), _tensors(restored)))
    mgr.close()
    mgr2.close()


def test_restore_copies_into_the_states_own_tensors(tmp_path):
    """Every tensor keeps its storage (``data_ptr``), the 0-d int32 step and
    Adam's count included, so a CUDA graph captured on the state stays
    valid; the save is a copy, not a view of the live state."""
    eng = _engine()
    state = eng.init(seed=0, device="cpu")
    b = next(iter(SyntheticSource(SCH, batch_size=64, seed=2)))
    state, _ = eng.train_step(state, *_args(b))
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, state)
    saved = [t.clone() for t in _tensors(state)]
    state, _ = eng.train_step(state, *_args(b))  # in place, after save returned
    mgr.wait()
    target = eng.init(seed=3, device="cpu")
    ptrs = [t.data_ptr() for t in _tensors(target)]
    mgr.restore(target)
    assert [t.data_ptr() for t in _tensors(target)] == ptrs
    assert all(torch.equal(a, b) for a, b in zip(_tensors(target), saved))
    assert target.step.dtype == torch.int32 and int(target.step) == 1
    assert int(target.dense_opt["count"]) == 1


def test_restore_missing_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "empty"))
    with pytest.raises(FileNotFoundError):
        mgr.restore(_engine("lr").init(seed=0, device="cpu"))
    with pytest.raises(FileNotFoundError):
        mgr.restore(_engine("lr").init(seed=0, device="cpu"), step=3)


def test_restore_into_another_model_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _engine("fm").init(seed=0, device="cpu"))
    with pytest.raises(ValueError, match="structure mismatch"):
        mgr.restore(_engine("deepfm").init(seed=0, device="cpu"))


def test_interval_first_save_force_and_max_to_keep(tmp_path):
    """orbax's policy: the first save happens at any step, later ones at a
    step past the latest that the interval divides, ``force`` at any new
    step; a step that exists raises; the newest ``max_to_keep`` stay."""
    state = _engine("lr").init(seed=0, device="cpu")
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2, save_interval_steps=10)
    saved = [s for s in (3, 5, 10, 10, 15, 20, 30) if mgr.save(s, state, {"at": s})]
    assert saved == [3, 10, 20, 30]
    assert not mgr.save(25, state)  # before the latest
    assert mgr.save(33, state, force=True)
    with pytest.raises(ValueError, match="already exists"):
        mgr.save(33, state, force=True)
    mgr.wait()
    assert sorted(int(d) for d in os.listdir(tmp_path) if d.isdigit()) == [30, 33]
    assert mgr.all_steps() == [30, 33] and mgr.latest_step() == 33
    with open(tmp_path / "30" / "data.json") as f:
        assert json.load(f) == {"at": 30}
    mgr.close()


def test_a_partial_directory_is_ignored(tmp_path):
    """What a write killed before its rename leaves (a ``.partial``
    directory), and a step-named directory without a state file, are not
    checkpoints; a new manager removes the partial one."""
    state = _engine("lr").init(seed=0, device="cpu")
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(4, state, {"step": 4})
    mgr.wait()
    os.makedirs(tmp_path / "9.partial")
    (tmp_path / "9.partial" / "state.pt").write_bytes(b"half a file")
    os.makedirs(tmp_path / "12")
    mgr2 = CheckpointManager(str(tmp_path))
    assert mgr2.latest_step() == 4 and not (tmp_path / "9.partial").exists()
    _, data = mgr2.restore(_engine("lr").init(seed=1, device="cpu"))
    assert data == {"step": 4}


def test_a_failed_write_raises_at_wait(tmp_path, monkeypatch):
    """The background write's error reaches the caller, and its step is not
    counted as a checkpoint."""
    state = _engine("lr").init(seed=0, device="cpu")
    mgr = CheckpointManager(str(tmp_path))

    def fail(*args, **kwargs):
        raise OSError("disk full")

    monkeypatch.setattr(torch, "save", fail)
    mgr.save(2, state)
    with pytest.raises(OSError, match="disk full"):
        mgr.wait()
    assert mgr.latest_step() is None and not os.path.exists(tmp_path / "2")
    assert os.listdir(tmp_path) == []


# ------------------------------------------- sharded states and geometries
def _fake_mesh(size: int, rank: int):
    """A mesh's geometry (no process group): enough for ``ShardedTables``'
    shapes and for ``restore_cross_geometry``'s fit, which runs no
    collective."""
    from recmodels_tpu_torch.parallel import Mesh

    return Mesh(group=None, size=size, rank=rank, device=torch.device("cpu"))


def _sharded_engine(mesh, model="fm", **kw):
    from recmodels_tpu_torch.parallel import build_parallel_engine

    return build_parallel_engine(build_model(model, SCH), mesh, dense_lr=1e-2, emb_lr=5e-2, **kw)


@pytest.mark.parametrize("opt", ["adagrad", "adam"])
def test_restore_cross_geometry_fits_each_ranks_block(tmp_path, opt):
    """A local checkpoint restored into each rank's block of a world of 4
    (the manager's fit, rank by rank): the blocks together are the saved
    tables and sparse states padded with zero rows to ``padded_rows``; the
    dense state, the step and the cursor pass through; each block is
    copied into the target's own tensors. Back from those blocks, saved as
    one global state, a local restore gives the saved state bit for bit."""
    from recmodels_tpu_torch.parallel import shard_state

    eng = _engine(sparse_optimizer=opt)
    state = eng.init(seed=0, device="cpu")
    b = next(iter(SyntheticSource(SCH, batch_size=64, seed=2)))
    state, _ = eng.train_step(state, *_args(b))
    mgr = CheckpointManager(str(tmp_path / "local"))
    mgr.save(1, state, {"step": 1})
    mgr.wait()
    blocks = []
    for rank in range(4):
        mesh = _fake_mesh(4, rank)
        sharded = _sharded_engine(mesh, sparse_optimizer=opt)
        target = shard_state(sharded.init(seed=5, device="cpu"), mesh)
        ptrs = [t.data_ptr() for t in _tensors(target)]
        got, data = mgr.restore_cross_geometry(target, mesh=mesh)
        assert got is target and [t.data_ptr() for t in _tensors(got)] == ptrs and data == {"step": 1}
        blocks.append(got)
    (g,) = eng.collections["emb"].groups
    rows = _sharded_engine(_fake_mesh(4, 0)).tables.padded_rows("emb", g)
    table = torch.cat([blk.emb_params["emb"][g.name] for blk in blocks])
    assert table.shape[0] == rows > g.alloc_rows
    assert torch.equal(table[: g.alloc_rows], state.emb_params["emb"][g.name])
    assert not table[g.alloc_rows:].any()
    for k, v in state.emb_opt["emb"][g.name].items():
        joined = torch.cat([blk.emb_opt["emb"][g.name][k] for blk in blocks])
        assert torch.equal(joined[: g.alloc_rows], v) and not joined[g.alloc_rows:].any()
    for blk in blocks:
        assert all(torch.equal(a, b) for a, b in zip(leaves(blk.dense_params), leaves(state.dense_params)))
        assert all(torch.equal(a, b) for a, b in zip(leaves(blk.dense_opt), leaves(state.dense_opt)))
        assert int(blk.step) == 1

    glob = blocks[0]._replace(emb_params={"emb": {g.name: table}}, emb_opt={"emb": {g.name: {
        k: torch.cat([blk.emb_opt["emb"][g.name][k] for blk in blocks]) for k in state.emb_opt["emb"][g.name]}}})
    mgr4 = CheckpointManager(str(tmp_path / "world4"))
    mgr4.save(1, glob, {"step": 1})
    with pytest.raises(ValueError, match="structure mismatch"):  # same-geometry restore refuses it
        mgr4.restore(eng.init(seed=6, device="cpu"))
    back, _ = mgr4.restore_cross_geometry(eng.init(seed=6, device="cpu"))
    assert all(torch.equal(a, b) for a, b in zip(_tensors(back), _tensors(state)))


def test_restore_cross_geometry_rejects_another_model(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _engine("fm").init(seed=0, device="cpu"))
    with pytest.raises(ValueError, match="structure mismatch"):
        mgr.restore_cross_geometry(_engine("deepfm").init(seed=0, device="cpu"))
    with pytest.raises(ValueError, match="structure mismatch"):
        mgr.restore_cross_geometry(_engine("fm", sparse_optimizer="adam").init(seed=0, device="cpu"))


@pytest.fixture(scope="module")
def world_of_one():
    """A gloo world of one rank in this process."""
    import torch.distributed as dist

    from recmodels_tpu_torch.parallel import make_mesh

    dist.init_process_group("gloo", store=dist.HashStore(), world_size=1, rank=0)
    try:
        yield make_mesh(1)
    finally:
        dist.destroy_process_group()


def test_sharded_save_gathers_and_restore_copies_rows(tmp_path, world_of_one):
    """A manager with the run's mesh (a world of one): ``gather_state`` is
    the global state (new tensors for the tables, the replicated ones
    shared); ``save`` writes it, ``restore`` copies it back into the
    block's own tensors bit for bit, and a resumed step equals the
    continued one."""
    from recmodels_tpu_torch.parallel import gather_state, shard_state

    mesh = world_of_one
    eng = _sharded_engine(mesh, "xdeepfm", sparse_optimizer="adam", fuse_wide=False)
    start = eng.init(seed=0, device="cpu")
    state = shard_state(start, mesh)
    it = iter(SyntheticSource(SCH, batch_size=64, seed=3))
    state, _ = eng.train_step(state, *_args(next(it)))
    glob = gather_state(state, mesh)
    assert all(torch.equal(a, b) for a, b in zip(_tensors(glob), _tensors(state)))
    assert glob.emb_params["emb"]["d8"].data_ptr() != state.emb_params["emb"]["d8"].data_ptr()
    assert all(a is b for a, b in zip(leaves(glob.dense_params), leaves(state.dense_params)))
    mgr = CheckpointManager(str(tmp_path), mesh=mesh)
    assert mgr.save(1, state, {"step": 1})
    mgr.wait()
    batch = _args(next(it))
    cont, _ = eng.train_step(state, *batch)
    want = [t.clone() for t in _tensors(cont)]
    target = shard_state(eng.init(seed=9, device="cpu"), mesh)
    ptrs = [t.data_ptr() for t in _tensors(target)]
    restored, data = mgr.restore(target)
    assert [t.data_ptr() for t in _tensors(restored)] == ptrs and data == {"step": 1}
    restored, _ = eng.train_step(restored, *batch)
    assert all(torch.equal(a, b) for a, b in zip(_tensors(restored), want))
