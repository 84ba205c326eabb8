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
