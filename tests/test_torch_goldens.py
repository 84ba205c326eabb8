"""The fixed-seed goldens of ``tests/test_goldens.py`` run through the port's
Trainer on the CPU: each configuration starts from the JAX Trainer's initial
state (jax.random and torch draw different numbers; the port's
``engine.init`` is replaced by that state) and trains 400 steps on the same
stream, and its validation AUC and logloss must land within the goldens'
own tolerances of the recorded values. FM, DeepFM and the flagship's bf16
xDeepFM run in Tier-1; the other seven carry ``slow``, as JAX's do."""

import dataclasses
import io

import jax
import pytest
import torch

from recmodels_tpu.train.loop import Trainer as JTrainer
from recmodels_tpu.utils.logging import MetricsLogger as JLogger
from recmodels_tpu_torch.train.loop import Trainer
from recmodels_tpu_torch.utils.config import TrainConfig
from recmodels_tpu_torch.utils.logging import MetricsLogger
from test_goldens import GOLDENS, _golden_cfg

TIER1 = ("fm", "deepfm", "xdeepfm_bf16")
CASES = [m if m in TIER1 else pytest.param(m, marks=pytest.mark.slow) for m in sorted(GOLDENS)]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Each test on one intra-op thread: the test run shares the host's cores
    among its workers, and torch's thread pool in each of them (one thread a
    core) oversubscribes the cores many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("model", CASES)
def test_fixed_seed_golden_from_jax_initial_state(model):
    from torch_jax_bridge import port_state_from_jax

    # batches come from one worker: the same stream as the pool's, without
    # spawning processes in the test run
    jcfg = dataclasses.replace(_golden_cfg(model), producer_workers=1)
    jt = JTrainer(jcfg, logger=JLogger(stream=io.StringIO()))
    jstate0 = jt.engine.init(jax.random.key(jcfg.seed))
    t = Trainer(TrainConfig.from_json(jcfg.to_json()), logger=MetricsLogger(stream=io.StringIO()),
                device="cpu")
    t.engine.init = lambda seed, device: port_state_from_jax(jt.engine, jstate0, t.engine)
    out = t.run()
    g = GOLDENS[model]
    assert abs(out["auc"] - g["auc"]) < 2e-3, (out, g)
    assert abs(out["logloss"] - g["logloss"]) < 4e-3, (out, g)
