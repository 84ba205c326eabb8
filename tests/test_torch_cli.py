"""The port's command-line entry points on the CPU (``--cpu``): train with
checkpoints, export the last one, score with the artifact and with the
checkpoint; the artifact loads in both packages and scores alike in both.
Without ``--cpu`` each entry point asks for the CUDA card and raises
without one."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recmodels_tpu.serve import load_predictor as jload
from recmodels_tpu_torch.cli import export as export_cli
from recmodels_tpu_torch.cli import predict as predict_cli
from recmodels_tpu_torch.cli import train as train_cli
from recmodels_tpu_torch.data import SyntheticSource
from recmodels_tpu_torch.serve import load_predictor
from recmodels_tpu_torch.train.checkpoint import CheckpointManager
from recmodels_tpu_torch.train.loop import Trainer
from recmodels_tpu_torch.utils.config import TrainConfig, build_schema

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "criteo_sample.tsv")
SETS = ["--set", "vocab_size=200", "--set", "embed_dim=8", "--set", "eval_every=20",
        "--set", "eval_batches=2", "--set", "log_every=10", "--set", "producer_workers=1"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Each test on one intra-op thread: the test run shares the host's cores
    among its workers, and torch's thread pool in each of them (one thread a
    core) oversubscribes the cores many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """20 steps of FM on a cosine schedule with warmup and decay, scan 5,
    checkpoints every 10, then the export of its last checkpoint."""
    root = tmp_path_factory.mktemp("cli")
    ckpt, art = str(root / "ckpt"), str(root / "art")
    rc = train_cli.main(["--cpu", "--model", "fm", "--steps", "20", "--batch-size", "64", "--ckpt-dir", ckpt,
                         *SETS, "--set", "scan_steps=5", "--set", "lr_schedule='cosine'",
                         "--set", "warmup_steps=5", "--set", "dense_weight_decay=1e-4",
                         "--set", "ckpt_every=10"])
    assert rc == 0
    assert export_cli.main(["--cpu", "--ckpt-dir", ckpt, "--out", art]) == 0
    return dict(root=root, ckpt=ckpt, art=art)


def test_train_cli_logs_trains_and_checkpoints(trained, capsys):
    assert sorted(int(d) for d in os.listdir(trained["ckpt"]) if d.isdigit()) == [5, 10, 20]
    cfg = TrainConfig.from_json(open(os.path.join(trained["ckpt"], "config.json")).read())
    assert (cfg.model, cfg.steps, cfg.lr_schedule, cfg.scan_steps) == ("fm", 20, "cosine", 5)
    rc = train_cli.main(["--cpu", "--model", "lr", "--steps", "20", "--batch-size", "64", *SETS])
    out = capsys.readouterr().out
    assert rc == 0 and "done:" in out and "auc" in out and "device=cpu" in out


def test_export_is_the_last_checkpoint(trained):
    """The artifact's logits are the restored checkpoint's ``Engine.logits``."""
    cfg = TrainConfig.from_json(open(os.path.join(trained["ckpt"], "config.json")).read())
    t = Trainer(cfg.apply_overrides([f"ckpt_dir={trained['ckpt']!r}"]), device="cpu")
    state, _ = t.ckpt.restore(t.engine.init(seed=0, device="cpu"))
    assert int(state.step) == 20
    b = next(iter(SyntheticSource(build_schema(cfg), batch_size=300, seed=9)))
    with torch.no_grad():
        want = t.engine.logits(state, torch.from_numpy(b.dense), torch.from_numpy(b.ids)).numpy()
    got = load_predictor(trained["art"], device="cpu").predict_logits(b.dense, b.ids)
    np.testing.assert_array_equal(got, want)


def test_artifact_loads_in_both_packages(trained):
    """The port's artifact, scored by the JAX package's Predictor: the
    same f32 model, logits to f32 rounding."""
    cfg = TrainConfig.from_json(open(os.path.join(trained["ckpt"], "config.json")).read())
    b = next(iter(SyntheticSource(build_schema(cfg), batch_size=100, seed=10)))
    port = load_predictor(trained["art"], device="cpu").predict_logits(b.dense, b.ids)
    jax_ = np.asarray(jload(trained["art"]).predict_logits(jnp.asarray(b.dense), jnp.asarray(b.ids)))
    np.testing.assert_allclose(port, jax_, rtol=1e-5, atol=1e-6)


def test_predict_cli_from_artifact_and_checkpoint(trained, capsys):
    """Two synthetic batches through the artifact write one probability a
    row, the checkpoint's; the fixture's 96 rows score in batches of 40
    (a masked tail of 16) through the native parser."""
    out = str(trained["root"] / "preds.txt")
    assert predict_cli.main(["--cpu", "--model-dir", trained["art"], "--data", "synthetic",
                             "--max-batches", "2", "--out", out]) == 0
    probs = np.loadtxt(out)
    assert probs.shape == (128,) and np.all((probs > 0) & (probs < 1))
    log = capsys.readouterr().out
    assert "eval n=128 auc=" in log
    out2 = str(trained["root"] / "preds2.txt")
    assert predict_cli.main(["--cpu", "--ckpt-dir", trained["ckpt"], "--data", "synthetic",
                             "--max-batches", "2", "--out", out2]) == 0
    np.testing.assert_array_equal(np.loadtxt(out2), probs)
    assert predict_cli.main(["--cpu", "--model-dir", trained["art"], "--data", FIXTURE,
                             "--batch-size", "40"]) == 0
    log = capsys.readouterr().out
    assert "restored step 20" in log and "eval n=96 auc=" in log


def test_entry_points_ask_for_the_card(trained):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(["--model", "lr", "--steps", "2", *SETS])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        export_cli.main(["--ckpt-dir", trained["ckpt"], "--out", str(trained["root"] / "x")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        predict_cli.main(["--model-dir", trained["art"], "--data", "synthetic"])


def test_checkpoint_manager_reads_the_cli_run(trained):
    mgr = CheckpointManager(trained["ckpt"])
    assert mgr.latest_step() == 20 and mgr.all_steps() == [5, 10, 20]
