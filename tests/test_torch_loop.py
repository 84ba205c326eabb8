"""The port's training loop (``recmodels_tpu_torch/train/loop.py``) on the CPU,
at ``tests/test_train_loop.py``'s sizes: it learns, it resumes bit for bit
(in process and after a SIGKILL), accumulation matches the full batch, and
from JAX's initial state it lands where JAX's ``Trainer`` lands."""

import io
import os
import signal
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

from recmodels_tpu.train.loop import Trainer as JTrainer
from recmodels_tpu.utils.config import TrainConfig as JConfig
from recmodels_tpu.utils.logging import MetricsLogger as JLogger
from recmodels_tpu_torch.train.loop import Trainer
from recmodels_tpu_torch.utils.config import TrainConfig
from recmodels_tpu_torch.utils.logging import MetricsLogger

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Each test on one intra-op thread: the test run shares the host's cores
    among its workers, and torch's thread pool in each of them (one thread a
    core) oversubscribes the cores many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _kw(**kw):
    base = dict(model="fm", vocab_size=500, embed_dim=8, batch_size=256, steps=150, log_every=50,
                eval_every=150, eval_batches=5, emb_lr=5e-2, n_devices=1, producer_workers=1)
    base.update(kw)
    return base


def _cfg(**kw):
    return TrainConfig(**_kw(**kw))


def _tensors(state):
    from recmodels_tpu_torch.utils.tree import leaves

    return [t for t in leaves(state._asdict()) if isinstance(t, torch.Tensor)]


def _equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(_tensors(a), _tensors(b)))


def test_trainer_learns_with_the_producer_pool():
    """150 steps of FM (batches from the spawned pool) reach AUC > 0.65 on
    the held-out stream, as JAX's ``test_trainer_single_device_learns``."""
    t = Trainer(_cfg(producer_workers=2), logger=MetricsLogger(stream=io.StringIO()), device="cpu")
    final = t.run()
    assert final["auc"] > 0.65 and np.isfinite(final["logloss"])
    assert int(t.state.step) == 150


def test_trainer_from_jax_initial_state_lands_on_jax_trainer():
    """The port's Trainer started from the JAX Trainer's initial state (the
    port's engine.init replaced by it) on the same stream and schedule-free
    config: the final AUC within 2e-3 (tests/test_goldens.py's bound) and
    the logloss within 4e-3 of JAX's."""
    from torch_jax_bridge import port_state_from_jax

    jt = JTrainer(JConfig(**_kw()), logger=JLogger(stream=io.StringIO()))
    jstate0 = jt.engine.init(jax.random.key(0))
    jfinal = jt.run()
    t = Trainer(_cfg(), logger=MetricsLogger(stream=io.StringIO()), device="cpu")
    t.engine.init = lambda seed, device: port_state_from_jax(jt.engine, jstate0, t.engine)
    final = t.run()
    assert abs(final["auc"] - jfinal["auc"]) < 2e-3, (final, jfinal)
    assert abs(final["logloss"] - jfinal["logloss"]) < 4e-3, (final, jfinal)


@pytest.mark.parametrize("scan", [1, 10])
def test_trainer_checkpoint_resume_bitwise(tmp_path, scan):
    """40 steps straight, and 20 steps then a new Trainer resuming to 40:
    every tensor of the final states equal bit for bit (constant lr, adamw
    decay, checkpoints every 10)."""
    kw = dict(steps=40, eval_every=0, ckpt_every=10, scan_steps=scan, dense_weight_decay=1e-4)
    quiet = dict(logger=MetricsLogger(stream=io.StringIO()), device="cpu")
    t1 = Trainer(_cfg(ckpt_dir=str(tmp_path / "a"), **kw), **quiet)
    t1.run()
    Trainer(_cfg(ckpt_dir=str(tmp_path / "b"), **{**kw, "steps": 20}), **quiet).run()
    log = io.StringIO()
    t3 = Trainer(_cfg(ckpt_dir=str(tmp_path / "b"), **kw), logger=MetricsLogger(stream=log), device="cpu")
    t3.run()
    assert "resumed from checkpoint at step 20" in log.getvalue()
    assert _equal(t1.state, t3.state) and int(t3.state.step) == 40
    assert sorted(int(d) for d in os.listdir(tmp_path / "b") if d.isdigit()) == [20, 30, 40]
    assert TrainConfig.from_json((tmp_path / "b" / "config.json").read_text()) == _cfg(
        ckpt_dir=str(tmp_path / "b"), **kw)


def test_trainer_scheduled_resume_bitwise(tmp_path):
    """On a cosine schedule with warmup (whose length is the run's steps) a
    run resumed from an earlier checkpoint of the same run (the later ones
    removed, as if it had died after step 10) reads the restored step and
    schedule count: bit for bit the straight run. The final checkpoint is
    forced at a step the interval does not divide."""
    import shutil

    kw = dict(steps=27, eval_every=0, ckpt_every=10, scan_steps=5, lr_schedule="cosine", warmup_steps=5,
              ckpt_dir=str(tmp_path))
    quiet = dict(logger=MetricsLogger(stream=io.StringIO()), device="cpu")
    t1 = Trainer(_cfg(**kw), **quiet)
    t1.run()
    assert sorted(int(d) for d in os.listdir(tmp_path) if d.isdigit()) == [10, 20, 27]
    for d in ("20", "27"):
        shutil.rmtree(tmp_path / d)
    t2 = Trainer(_cfg(**kw), **quiet)
    t2.run()
    assert _equal(t1.state, t2.state) and int(t2.state.dense_opt["schedule_count"]) == 27


def test_trainer_accum_steps_matches_full_batch():
    """accum_steps=4 trains the trajectory of accum_steps=1 on the same
    stream, within tests/test_train_loop.py's bounds."""
    t1 = Trainer(_cfg(steps=30, eval_every=30), device="cpu", logger=MetricsLogger(stream=io.StringIO()))
    f1 = t1.run()
    t2 = Trainer(_cfg(steps=30, eval_every=30, accum_steps=4), device="cpu",
                 logger=MetricsLogger(stream=io.StringIO()))
    f2 = t2.run()
    assert abs(f1["auc"] - f2["auc"]) < 2e-3
    for a, b in zip(_tensors(t1.state), _tensors(t2.state)):
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(), rtol=5e-3, atol=1e-4)


def test_trainer_accum_steps_composes_with_scan():
    t = Trainer(_cfg(steps=80, eval_every=80, scan_steps=4, accum_steps=2), device="cpu",
                logger=MetricsLogger(stream=io.StringIO()))
    assert t.run()["auc"] > 0.62 and int(t.state.step) == 80


def test_trainer_raises_for_what_is_not_ported():
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1, item 6"):
        Trainer(_cfg(data="device_synth"), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1, item 7"):
        Trainer(_cfg(n_devices=8), device="cpu")
    with pytest.raises(ValueError, match="not divisible by accum_steps"):
        Trainer(_cfg(accum_steps=3), device="cpu")


def test_trainer_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(_cfg())


def test_profile_dir_traces_superbatches_two_to_four(tmp_path):
    log = io.StringIO()
    t = Trainer(_cfg(steps=12, eval_every=0, scan_steps=2), device="cpu", logger=MetricsLogger(stream=log))
    t.profile_dir = str(tmp_path)
    t.run()
    assert (tmp_path / "trace.json").stat().st_size > 0
    assert f"profiler trace written to {tmp_path}" in log.getvalue()


def test_logger_without_tensorboard_says_so(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    out = io.StringIO()
    logger = MetricsLogger(str(tmp_path), stream=out)
    logger.log_scalars(3, {"loss": 0.5})
    lines = out.getvalue().splitlines()
    assert "TB logging disabled" in lines[0] and 'step        3 train {"loss": 0.5}' in lines[1]
    assert not any(tmp_path.iterdir())


SIGKILL_SCRIPT = r"""
import sys
import numpy as np
from recmodels_tpu_torch.train.loop import Trainer
from recmodels_tpu_torch.utils.config import TrainConfig
from recmodels_tpu_torch.utils.tree import leaves

ckpt, steps = sys.argv[1], int(sys.argv[2])
cfg = TrainConfig(model="fm", vocab_size=300, embed_dim=8, batch_size=64, steps=steps, log_every=10,
                  eval_every=0, emb_lr=5e-2, n_devices=1, ckpt_dir=ckpt, ckpt_every=5)
t = Trainer(cfg, device="cpu")
t.run()
np.save(ckpt + "/final.npy", np.concatenate(
    [x.float().numpy().ravel() for x in leaves(t.state._asdict())]))
print("FINISHED")
"""


def _run_drill(ckpt: str, steps: int, kill_after: int | None = None):
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")  # one thread, as _one_torch_thread
    p = subprocess.Popen([sys.executable, "-c", SIGKILL_SCRIPT, ckpt, str(steps)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, cwd=ROOT)
    if kill_after is not None:
        deadline = time.time() + 120
        while time.time() < deadline and p.poll() is None:
            if os.path.isdir(ckpt) and any(d.isdigit() and int(d) >= kill_after for d in os.listdir(ckpt)):
                break
            time.sleep(0.05)
        p.send_signal(signal.SIGKILL)
        p.wait(timeout=60)
        return None
    out, _ = p.communicate(timeout=300)
    assert b"FINISHED" in out, out.decode()[-2000:]
    return out


def test_sigkill_resume_identical(tmp_path):
    """tests/test_resilience.py's drill on the port: SIGKILL a training
    process once a checkpoint at step >= 10 exists, restart it, and the
    final state equals an uninterrupted run's byte for byte."""
    a, b = str(tmp_path / "uninterrupted"), str(tmp_path / "killed")
    _run_drill(a, 30)
    _run_drill(b, 30, kill_after=10)
    assert not os.path.exists(b + "/final.npy")  # it died early
    _run_drill(b, 30)
    np.testing.assert_array_equal(np.load(a + "/final.npy"), np.load(b + "/final.npy"))


def test_logger_writes_tensorboard_scalars(monkeypatch, tmp_path):
    """With ``torch.utils.tensorboard`` present each scalar goes to its
    writer under ``<prefix>/<name>`` at the step (a stand-in writer records
    the calls), and ``close`` closes it."""
    import types

    calls = []

    class Writer:
        def __init__(self, logdir):
            calls.append(("open", logdir))

        def add_scalar(self, tag, value, step):
            calls.append((tag, value, step))

        def close(self):
            calls.append(("close",))

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", types.SimpleNamespace(SummaryWriter=Writer))
    logger = MetricsLogger(str(tmp_path), stream=io.StringIO())
    logger.log_scalars(7, {"auc": 0.75, "logloss": 0.5}, prefix="val")
    logger.close()
    assert calls == [("open", str(tmp_path)), ("val/auc", 0.75, 7), ("val/logloss", 0.5, 7), ("close",)]


def test_profiling_trace_annotate_and_step_timer(tmp_path):
    from recmodels_tpu_torch.utils.profiling import StepTimer, annotate, trace

    with trace(str(tmp_path)):
        with annotate("the-region"):
            torch.ones(8).sum()
    assert "the-region" in (tmp_path / "trace.json").read_text()
    timer = StepTimer(alpha=0.5)
    assert timer.tick() is None
    time.sleep(0.01)
    first = timer.tick()
    assert first is not None and first > 0 and timer.ema_s == first


def test_a_failing_step_stops_the_run_and_its_pool():
    """An error in a step while the producer pool still makes batches (of a
    megabyte and more) reaches the caller, and the run's clean-up returns:
    the pool's shutdown does not wait on batches nobody reads."""
    import threading

    t = Trainer(_cfg(steps=400, batch_size=8192, scan_steps=2, eval_every=0, producer_workers=2),
                logger=MetricsLogger(stream=io.StringIO()), device="cpu")
    calls = []

    def failing_scan(state, *batch):
        calls.append(1)
        if len(calls) == 3:
            raise RuntimeError("the step failed")
        return state, {"loss": torch.zeros(()), "overflow": 0}

    t.train_scan = failing_scan
    raised = []

    def run():
        try:
            t.run()
        except RuntimeError as e:
            raised.append(str(e))

    th = threading.Thread(target=run)
    th.start()
    th.join(timeout=120)
    assert not th.is_alive() and raised == ["the step failed"]
